"""End-to-end op tracing: the ZTracer/blkin analog.

Port of ``ceph_tpu/common/tracer.py``. Role of the reference's
ZTracer::Trace + blkin integration (src/common/zipkin_trace.h; spans
threaded through the EC write path at ECBackend.cc:1978-1983, one child
span per shard) plus the TracepointProvider config gating
(src/common/TracepointProvider.h: tracing is zero-cost until an option
turns it on).

Pieces:

  Span           one named monotonic-clock interval with parent/child
                 links, keyval annotations and point events.  trace_id
                 ties spans of ONE logical op together across daemons;
                 (trace_id, parent_span) ride message envelopes so the
                 receiving daemon's spans stitch under the sender's.
  NULL_SPAN      the shared no-op span: the disabled-tracing fast path
                 (instrumented code pays one truthiness check).
  SpanCollector  per-daemon bounded span ring, config-gated on
                 `osd_tracing` with an `osd_tracing_sample` 1-in-N knob
                 for hot paths; serves `dump_tracing` / `trace reset`
                 over an admin socket.
  TailSampler    tail-based retention (Dapper/Canopy discipline): the
                 keep/drop call moves to op COMPLETION on the root
                 daemon — SLO-slow, errored, or reservoir-sampled
                 traces are kept; replicas buffer fragments until the
                 verdict and dropped traces cost zero wire bytes.
  trace_ctx      (trace_id, parent_span_id) for a message envelope.
  device_segments  the one device-call shape everyone shares: run a
                 codec call split into h2d / compute / d2h legs on a
                 torch device (the dispatcher's depth-1 path rides it).
  render_tree    the `trace tree` renderer: stitched span tree with
                 per-span self-times.

A `conf` is duck-typed as in the reference: ``get_val(key)`` (raising
KeyError for an unknown option) and ``add_observer(obs)`` with the
md_config_obs_t contract (``get_tracked_keys``, ``handle_conf_change``).
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from collections import deque

import numpy as np
import torch

from ..device import host_tensor, pinned_copy, to_numpy

__all__ = ["Span", "NULL_SPAN", "SpanCollector", "TailSampler",
           "parse_slo_targets", "trace_ctx", "wire_span",
           "device_segments", "render_tree"]

# span ids must be unique ACROSS daemons for one trace (shards' spans
# from different OSDs land in one tree): a per-process random high part
# over a process-local counter keeps multi-process traces collision-free
_ids = itertools.count(1)
_ID_BASE = (int.from_bytes(os.urandom(3), "big") | 1) << 40


def _next_id() -> int:
    return _ID_BASE | next(_ids)


class Span:
    """One span: a named interval with keyvals, events and lineage."""

    __slots__ = ("collector", "name", "endpoint", "trace_id", "span_id",
                 "parent_id", "start", "start_wall", "end", "keyvals",
                 "events")

    def __init__(self, collector, name, endpoint="", trace_id=None,
                 parent_id=None):
        self.collector = collector
        self.name = name
        self.endpoint = endpoint
        self.span_id = _next_id()
        self.trace_id = trace_id if trace_id else self.span_id
        self.parent_id = parent_id
        self.start = time.monotonic()
        self.start_wall = time.time()
        self.end: float | None = None
        self.keyvals: dict = {}
        self.events: list[tuple[float, str]] = []

    def valid(self) -> bool:
        return True

    def child(self, name: str) -> "Span":
        return Span(self.collector, name, self.endpoint,
                    trace_id=self.trace_id, parent_id=self.span_id)

    def child_interval(self, name: str, start: float, end: float,
                       **keyvals) -> "Span":
        """Record an already-measured interval as a finished child
        (monotonic stamps) — how the dispatcher back-fills queue-delay
        and device-segment spans it could only time, not wrap."""
        s = self.child(name)
        s.start_wall = s.start_wall - (s.start - start)
        s.start = start
        s.keyvals.update(keyvals)
        s.end = end
        s.collector._record(s)
        return s

    def keyval(self, key: str, value) -> None:
        self.keyvals[key] = value

    def event(self, name: str) -> None:
        self.events.append((time.monotonic(), name))

    def finish(self) -> None:
        if self.end is None:
            self.end = time.monotonic()
            self.collector._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    def dump(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "endpoint": self.endpoint, "start": self.start,
                "start_wall": self.start_wall,
                "duration": (self.end if self.end is not None
                             else time.monotonic()) - self.start,
                "keyvals": dict(self.keyvals),
                "events": list(self.events)}

    def dump_wire(self) -> list:
        """Compact fixed-order form for MTraceFragment payloads (see
        wire_span): a fragment carries dozens of spans, and encoding
        ten string keys per span would dominate the shipping cost.
        trace_id and start_wall are omitted — the fragment envelope
        carries the trace_id and the (anchor_wall, anchor_mono) pair
        that re-anchors `start`."""
        return [self.span_id, self.parent_id, self.name,
                self.endpoint, self.start,
                (self.end if self.end is not None
                 else time.monotonic()) - self.start,
                dict(self.keyvals), list(self.events)]


class _NullSpan:
    """Shared no-op span: the disabled-tracing fast path."""

    __slots__ = ()
    trace_id = 0
    span_id = 0

    def valid(self) -> bool:
        return False

    def child(self, name: str) -> "_NullSpan":
        return self

    def child_interval(self, name, start, end, **kv) -> "_NullSpan":
        return self

    def keyval(self, key: str, value) -> None:
        pass

    def event(self, name: str) -> None:
        pass

    def finish(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


NULL_SPAN = _NullSpan()


def trace_ctx(span) -> tuple[int, int]:
    """(trace_id, parent_span_id) for a message envelope; (0, 0) rides
    when tracing is off, and a receiver seeing trace_id 0 stays null."""
    return (span.trace_id, span.span_id)


def wire_span(rec, trace_id: int) -> dict:
    """Expand one Span.dump_wire record back into the dict form the
    stores and render_tree consume."""
    return {"trace_id": trace_id, "span_id": rec[0],
            "parent_id": rec[1], "name": rec[2], "endpoint": rec[3],
            "start": rec[4], "duration": rec[5],
            "keyvals": rec[6], "events": rec[7]}


def parse_slo_targets(raw: str) -> dict:
    """'pool:latency_ms:objective,...' -> {pool: (threshold_s,
    objective)}; malformed entries are skipped, never fatal.  Shared
    by the mgr SLO evaluator and the OSD tail sampler so both judge
    "slow" against the identical per-pool threshold."""
    out = {}
    for entry in (raw or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.rsplit(":", 2)
        if len(parts) != 3:
            continue
        pool, lat_ms, objective = parts
        try:
            lat_s = float(lat_ms) / 1e3
            obj = float(objective)
        except ValueError:
            continue
        if not pool or lat_s <= 0 or not 0.0 < obj < 1.0:
            continue
        out[pool] = (lat_s, obj)
    return out


class SpanCollector:
    """Per-daemon bounded span store, `osd_tracing`-gated.

    Pass a Config to have enablement + the sampling knob follow
    `osd_tracing` / `osd_tracing_sample` (hot-toggling included via the
    config observer); without one, toggle `.enabled` directly.
    """

    def __init__(self, capacity: int = 8192, conf=None,
                 endpoint: str = ""):
        self.endpoint = endpoint
        self.enabled = False
        self.sample = 1
        self._sample_ctr = itertools.count()
        self._lock = threading.Lock()
        if conf is not None:
            try:
                capacity = int(conf.get_val("osd_tracing_max_spans"))
                self.enabled = bool(conf.get_val("osd_tracing"))
                self.sample = max(1, int(
                    conf.get_val("osd_tracing_sample")))
            except KeyError:
                pass  # options not in the schema: stay disabled
            else:
                collector = self

                class _Obs:  # md_config_obs_t contract
                    def get_tracked_keys(self):
                        return ("osd_tracing", "osd_tracing_sample")

                    def handle_conf_change(self, cfg, changed):
                        collector.enabled = bool(
                            cfg.get_val("osd_tracing"))
                        collector.sample = max(1, int(
                            cfg.get_val("osd_tracing_sample")))

                conf.add_observer(_Obs())
        self.capacity = capacity
        self._spans: deque[Span] = deque(maxlen=capacity)
        #: optional TailSampler: every recorded span is offered to it
        #: so replicas can buffer fragments pending the root's verdict
        self.tail = None

    # -- span minting --------------------------------------------------

    def start_trace(self, name: str, endpoint: str | None = None):
        """Root span (sampling applies here), or NULL_SPAN."""
        if not self.enabled:
            return NULL_SPAN
        if self.sample > 1 and next(self._sample_ctr) % self.sample:
            return NULL_SPAN
        return Span(self, name,
                    self.endpoint if endpoint is None else endpoint)

    def continue_trace(self, name: str, trace_id: int, parent_id: int,
                       endpoint: str | None = None):
        """Stitch onto a trace context from a message envelope; the
        sampling decision was the root's — a nonzero trace_id means the
        originator chose to trace this op."""
        if not self.enabled or not trace_id:
            return NULL_SPAN
        return Span(self, name,
                    self.endpoint if endpoint is None else endpoint,
                    trace_id=trace_id, parent_id=parent_id or None)

    # -- storage -------------------------------------------------------

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
        tail = self.tail
        if tail is not None:
            tail.observe(span)

    def dump(self, trace_id: int | None = None) -> list[dict]:
        with self._lock:
            spans = list(self._spans)
        return [s.dump() for s in spans
                if trace_id is None or s.trace_id == trace_id]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- admin socket surface ------------------------------------------

    def register_admin_commands(self, asok) -> None:
        def _dump(args: dict) -> dict:
            tid = args.get("trace_id") or args.get("key")
            tid = int(tid, 0) if isinstance(tid, str) else tid
            spans = self.dump(tid)
            return {"enabled": self.enabled, "sample": self.sample,
                    "num_spans": len(spans), "spans": spans}

        asok.register("dump_tracing", _dump,
                      "dump collected op spans (optional trace_id)")
        asok.register("trace reset",
                      lambda args: (self.clear(), {"reset": True})[1],
                      "drop all collected spans")


class TailSampler:
    """Tail-based trace retention: the keep/drop call at op COMPLETION.

    Two roles share one object per daemon:

      root side     `verdict(pool, duration, result, spans)` decides
                    keep/drop once the op's wall latency and result are
                    known — keep if latency exceeds the pool's SLO
                    threshold (`mgr_slo_pool_targets`, the same string
                    the mgr burns against), if the op errored or any
                    span logged an error event, or by a reservoir draw
                    (`osd_trace_tail_sample_rate`).
      replica side  `observe(span)` (fed by SpanCollector._record via
                    `.tail`) buffers finished span fragments keyed by
                    trace_id; `take(trace_id)` pops them when the
                    root's verdict arrives; fragments whose verdict
                    never comes expire after `osd_trace_pending_ttl`
                    seconds — a dropped trace costs zero wire bytes.

    The RNG is injectable so reservoir statistics are testable on a
    seeded stream.  The pending buffer is bounded (drop-oldest).
    """

    def __init__(self, conf=None, rng=None, max_pending: int = 4096):
        self._lock = threading.Lock()
        self.rng = rng if rng is not None else random.Random()
        self.rate = 0.0
        self.pending_ttl = 5.0
        self.slo_targets: dict = {}
        self.max_pending = max_pending
        self._pending: dict[int, tuple[float, list]] = {}
        self._last_sweep = time.monotonic()
        self.stats = {"kept_slo": 0, "kept_error": 0,
                      "kept_reservoir": 0, "dropped": 0,
                      "pending_expired": 0, "pending_overflow": 0}
        self.pool_stats: dict[str, dict] = {}
        if conf is not None:
            try:
                self.rate = float(
                    conf.get_val("osd_trace_tail_sample_rate"))
                self.pending_ttl = float(
                    conf.get_val("osd_trace_pending_ttl"))
                self.slo_targets = parse_slo_targets(
                    conf.get_val("mgr_slo_pool_targets"))
            except KeyError:
                pass  # options not in the schema: defaults stand
            else:
                sampler = self

                class _Obs:  # md_config_obs_t contract
                    def get_tracked_keys(self):
                        return ("osd_trace_tail_sample_rate",
                                "osd_trace_pending_ttl",
                                "mgr_slo_pool_targets")

                    def handle_conf_change(self, cfg, changed):
                        sampler.rate = float(
                            cfg.get_val("osd_trace_tail_sample_rate"))
                        sampler.pending_ttl = float(
                            cfg.get_val("osd_trace_pending_ttl"))
                        sampler.slo_targets = parse_slo_targets(
                            cfg.get_val("mgr_slo_pool_targets"))

                conf.add_observer(_Obs())

    # -- root side: the keep/drop call ---------------------------------

    def verdict(self, pool: str, duration: float, result,
                spans=None) -> tuple[bool, str]:
        """(keep, reason) for a completed root op; reason one of
        "slo" | "error" | "reservoir" | ""."""
        keep, reason = False, ""
        tgt = self.slo_targets.get(pool)
        if tgt is not None and duration > tgt[0]:
            keep, reason = True, "slo"
        elif (result is not None and result < 0) or \
                self._has_error_event(spans):
            keep, reason = True, "error"
        elif self.rate > 0.0 and self.rng.random() < self.rate:
            keep, reason = True, "reservoir"
        ps = self.pool_stats.setdefault(
            pool, {"seen": 0, "kept": 0})
        ps["seen"] += 1
        if keep:
            ps["kept"] += 1
            self.stats["kept_" + reason] += 1
        else:
            self.stats["dropped"] += 1
        return keep, reason

    @staticmethod
    def _has_error_event(spans) -> bool:
        for s in spans or ():
            events = s[7] if isinstance(s, (list, tuple)) \
                else s.get("events")
            for _, name in (events or ()):
                if str(name).startswith("error"):
                    return True
        return False

    # -- replica side: pending fragments -------------------------------

    def observe(self, span) -> None:
        """Buffer a finished span under its trace_id until the root's
        verdict arrives (or the TTL reaps it) — in the compact
        dump_wire form, ready to ship without another conversion."""
        if not span.trace_id:
            return
        now = time.monotonic()
        with self._lock:
            entry = self._pending.get(span.trace_id)
            if entry is None:
                if len(self._pending) >= self.max_pending:
                    oldest = min(self._pending,
                                 key=lambda t: self._pending[t][0])
                    del self._pending[oldest]
                    self.stats["pending_overflow"] += 1
                entry = self._pending[span.trace_id] = (now, [])
            entry[1].append(span.dump_wire())
        self._maybe_sweep(now)

    def take(self, trace_id: int):
        """Pop and return a trace's buffered span dumps (None if the
        TTL already reaped them or nothing was traced here)."""
        with self._lock:
            entry = self._pending.pop(trace_id, None)
        return entry[1] if entry is not None else None

    def pending_traces(self) -> int:
        with self._lock:
            return len(self._pending)

    def sweep(self, now: float | None = None) -> int:
        """Reap pending fragments older than the TTL (the root died or
        judged drop — drops send nothing).  Returns traces reaped."""
        now = time.monotonic() if now is None else now
        with self._lock:
            dead = [tid for tid, (t0, _) in self._pending.items()
                    if now - t0 > self.pending_ttl]
            for tid in dead:
                del self._pending[tid]
            self.stats["pending_expired"] += len(dead)
        return len(dead)

    def _maybe_sweep(self, now: float) -> None:
        # opportunistic, timer-free: at most ~1 sweep/second, driven
        # by whatever traffic flows through observe()
        if now - self._last_sweep >= 1.0:
            self._last_sweep = now
            self.sweep(now)


# -- shared device-call segmentation -----------------------------------

def device_segments(fn, batch: np.ndarray, device: torch.device):
    """Run fn on host array `batch` as an explicit h2d -> compute -> d2h
    sequence on `device` and time each leg. Returns (host ndarray result,
    {"h2d", "compute", "d2h"} seconds).

    On CUDA the legs run on the current stream: h2d copies a pinned host
    buffer with ``non_blocking=True``, d2h copies into pinned host memory,
    and each leg is timed between ``torch.cuda.Event``s (the host's
    pinning copy falls inside the h2d leg). On the CPU the legs are
    timed with the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        x = host_tensor(batch)
        t1 = time.perf_counter()
        out = fn(x)
        t2 = time.perf_counter()
        out = to_numpy(out)
        t3 = time.perf_counter()
        return out, {"h2d": t1 - t0, "compute": t2 - t1, "d2h": t3 - t2}
    stream = torch.cuda.current_stream(device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record(stream)
    dev = host_tensor(batch).pin_memory().to(device, non_blocking=True)
    ev[1].record(stream)
    out = fn(dev)
    ev[2].record(stream)
    host = pinned_copy(out)
    ev[3].record(stream)
    ev[3].synchronize()
    return to_numpy(host), {"h2d": ev[0].elapsed_time(ev[1]) / 1e3,
                          "compute": ev[1].elapsed_time(ev[2]) / 1e3,
                          "d2h": ev[2].elapsed_time(ev[3]) / 1e3}


# -- tree rendering (the `ceph trace tree` surface) --------------------

def _fmt_dur(seconds: float) -> str:
    if seconds >= 1.0:
        return "%.3fs" % seconds
    if seconds >= 1e-3:
        return "%.2fms" % (seconds * 1e3)
    return "%.0fus" % (seconds * 1e6)


def render_tree(spans: list[dict], trace_id: int | None = None) -> str:
    """Render stitched spans (possibly gathered from several daemons'
    dump_tracing) as an indented tree with self-times.  Spans whose
    parent is not in the set render as roots — a partial gather still
    produces a readable forest.  Siblings sort by wall stamp (the
    anchor-aligned "wall" when the mgr stitched them, start_wall
    otherwise) — monotonic clocks don't compare across processes."""
    if trace_id is not None:
        spans = [s for s in spans if s.get("trace_id") == trace_id]
    if not spans:
        return "(no spans)"
    by_id = {s["span_id"]: s for s in spans}
    children: dict = {}
    roots: list = []
    for s in spans:
        parent = s.get("parent_id")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)

    def order(kids: list) -> list:
        # sort siblings uniformly by the wall axis: "wall" is the
        # anchor-aligned stamp the mgr stitcher computes per fragment,
        # start_wall the span's own time.time() fallback.  Monotonic
        # `start` never orders spans across processes, and mixing the
        # two keys (the old endpoint-count special case) mis-ordered
        # same-endpoint siblings whenever a cross-daemon sibling sat
        # beside them.
        return sorted(kids, key=lambda s: (
            s.get("wall", s.get("start_wall", 0.0)),
            s.get("start", 0.0)))

    lines: list[str] = []
    traces = sorted({s.get("trace_id") for s in spans})
    endpoints = sorted({s.get("endpoint", "") for s in spans})
    lines.append("trace%s %s  (%d spans, %d endpoint(s): %s)"
                 % ("s" if len(traces) > 1 else "",
                    ", ".join(str(t) for t in traces), len(spans),
                    len(endpoints), ", ".join(e or "?"
                                              for e in endpoints)))

    def walk(s: dict, depth: int) -> None:
        kids = order(children.get(s["span_id"], []))
        dur = s.get("duration", 0.0)
        self_t = max(0.0, dur - sum(k.get("duration", 0.0)
                                    for k in kids))
        kv = s.get("keyvals") or {}
        kv_txt = ("  {%s}" % ", ".join(
            "%s=%s" % (k, v) for k, v in sorted(kv.items()))) if kv \
            else ""
        lines.append("%s%s @%s  %s (self %s)%s"
                     % ("  " * depth + ("- " if depth else ""),
                        s["name"], s.get("endpoint") or "?",
                        _fmt_dur(dur), _fmt_dur(self_t), kv_txt))
        for k in kids:
            walk(k, depth + 1)

    for root in order(roots):
        walk(root, 1)
    return "\n".join(lines)
