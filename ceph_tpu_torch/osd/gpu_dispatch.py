"""Cross-op device-call coalescing + overlapped pipeline for the EC hot path.

Port of ``ceph_tpu/osd/tpu_dispatch.py`` (``TpuDispatcher`` ->
``GpuDispatcher``). The reference's ECBackend enters the codec once per op
(src/osd/ECBackend.cc:1437 submit_transaction -> ECUtil::encode per
transaction); under concurrency each op would pay its own device
dispatch. Stripes are embarrassingly parallel, so concurrent ops that
share a generator (same pool/codec) or a decode matrix (same erasure
signature) CONCATENATE along the stripe axis and ride ONE kernel launch —
N dispatches become ceil(N / max_batch).

The dispatcher is an overlapped depth-N pipeline:

    collector ──> [h2d stage] ──> [compute stage] ──> [d2h stage]
                 stage batch n+1    run batch n       drain batch n-1

Each stage runs on its own thread; the bounded queues between them are
the staging ring (at most `pipeline_depth` fused batches in flight per
stage). On CUDA each stage has its own stream: h2d copies a pinned host
buffer into a device staging buffer on a copy stream, compute runs the
codec on a compute stream, d2h copies into pinned host memory on a third
stream, and CUDA events order the three. Decode dispatches pre-stage
their decode table (matrix inversion + bitmatrix upload) in the h2d
stage, so a fresh erasure signature's table cost overlaps the previous
batch's compute instead of serializing in front of its own.

The device staging buffer is dispatcher-private, so once compute has
consumed it, it goes back to a small free list and the next batch of the
same shape is copied into it (the reference donated it to the jitted
program instead; ``l_gpu_reused`` counts the reuses).

Facades: encode_async()/decode_async() return futures; encode()/decode()
keep the blocking surface. A regenerating code's repair rides the same
pipeline: repair_fraction_async() (a helper's [B, chunk] streams to its
[B, chunk/alpha] fractions) and repair_combine_async() (the d fractions
stacked [B, d, sub] to the rebuilt [B, chunk]), each with its matrix
pre-staged like a decode table, and their blocking forms. Errors propagate strictly per batch: a failed
stage fails ONLY that fused batch's submitters; batches behind it keep
flowing. pipeline_depth=1 runs the synchronous loop on the collector
thread, with its legs timed by ``common.tracer.device_segments``.

Whole-object writes ride the same pipeline through the fused write
transform (``fused_write_async``): digests, compression decision and
encode in one dispatch per object, never coalesced, with every output
drained by one d2h.

``resident=(tier, key)`` on an encode or a fused write asks the pipeline
to adopt what it staged and computed into the device chunk tier
(``osd/hbm_tier.py``): the staged data rows and the parity of an encode;
the staged raw rows, the parity and the shard crcs of a store-mode fused
write; the stored rows and parity of a compress-mode one. Pipelined, the
arrays are already on the device, so adoption moves no chunk byte from
the host; it runs on the d2h stream after the result's copy, and a
staging buffer goes back to the pool only once the tier's copy of it is
made (otherwise the next batch of the shape would be staged into the
rows being adopted). At depth 1 the tier adopts the host arrays, as the
reference's synchronous path does. An adoption failure never fails the
submitter: the tier is a cache.

Telemetry, as in the reference: ``telemetry()`` (queue depth, coalescing
ratio, the fused-write ledger and rolling per-codec MB/s under a label of
class name and k, m), ``dispatch_status()`` (pipeline shape, ring
occupancy, segment averages) and ``dispatch_profile()``, the stall
attribution: every stage thread (collector, h2d, compute, d2h) is at each
instant busy, idle (waiting on its upstream ring) or blocked (waiting to
push downstream), its seconds in each state are the
``l_gpu_stage_<stage>_<state>`` counters, each ring integrates its
occupancy over time, and the verdict names the device stage with the
highest busy share ("h2d-bound 71%") unless no stage is busy half the
window and the collector idles more ("collector-starved 88%").
``profile_reset()`` restarts the window. On CUDA a leg synchronises its
own stream, so a stage's busy interval brackets its device work and its
host work (the h2d leg's stacking and pinning copy included); on the CPU
the legs are plain calls. The ``l_gpu_*`` counters keep the reference's
``l_tpu_*`` names with ``gpu`` for ``tpu``, and ``l_gpu_reused`` stands
for ``l_tpu_donated`` (``dispatch_status()["donated_dispatches"]`` reads
it); ``l_gpu_h2d_bytes``, ``l_gpu_adopted`` and ``l_gpu_adopt_failed`` are
the port's own.

With a ``tracer`` (``common/tracer.SpanCollector``) whose collection is
enabled, the depth-1 path credits its measured legs to the stage
machines, as the reference's instrumented synchronous path does; a
submitter's span gets its ``gpu_queue`` and ``gpu_device`` children (h2d,
compute and d2h under the latter) at any depth whenever it is valid.

Device-memory ledger (``common/profiler.PROFILER``): the h2d leg adds the
staged bytes to ``staging_ring`` and they leave it when the staging
buffer is released (after compute, after the tier's copy, or on a
failure). The reference donates its staged input to the jitted program
and accounts it under ``donated_buffers`` while the program runs; the
port reuses the buffer instead (``_CudaDevOps._take`` / ``release``), so
``donated_buffers`` holds the bytes of the staging buffers kept for
reuse. On the CPU nothing is staged on a device and neither category is
touched.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from ..common.perf_counters import PerfCountersBuilder
from ..common.profiler import PROFILER
from ..common.tracer import NULL_SPAN, device_segments
from ..device import (device_label, host_tensor, pinned_copy,
                      resolve_device, to_numpy)
from ..models.table_cache import device_entry_key

__all__ = ["GpuDispatcher"]

# pipeline stages in flow order; the three device stages carry the
# bound-stage verdict, the collector carries the starvation verdict
_STAGES = ("collector", "h2d", "compute", "d2h")
_STATES = ("busy", "idle", "blocked")


class _Pending:
    """One submitter's slot in a fused dispatch — and the future the
    async API hands back (result()/done()/exception())."""

    __slots__ = ("batch", "event", "out", "error", "trace", "t_submit",
                 "resident")

    def __init__(self, batch, trace=NULL_SPAN, resident=None):
        self.batch = batch
        self.event = threading.Event()
        self.out = None
        self.error = None
        self.trace = trace if trace is not None else NULL_SPAN
        self.t_submit = time.monotonic()
        self.resident = resident     # (tier, key, codec) adoption ask

    # -- future surface ------------------------------------------------

    def done(self) -> bool:
        return self.event.is_set()

    def exception(self):
        return self.error if self.event.is_set() else None

    def result(self, timeout: float = 120.0):
        if not self.event.wait(timeout=timeout):
            raise TimeoutError("gpu dispatcher wedged")
        if self.error is not None:
            raise self.error
        return self.out


class _Dispatch:
    """One fused kernel launch moving through the pipeline stages."""

    __slots__ = ("key", "fn", "pend", "prefetch", "kind", "dev", "ready",
                 "out_dev", "done", "t_take", "seg", "mem_bytes")

    def __init__(self, key, fn, pend, prefetch=None, kind="codec"):
        self.key = key
        self.fn = fn
        self.pend = pend
        self.prefetch = prefetch     # () -> None decode-table staging
        self.kind = kind             # "codec" or "fused"
        self.dev = None              # staged device input
        self.ready = None            # event: staged input landed
        self.out_dev = None          # device output
        self.done = None             # event: compute finished
        self.t_take = time.monotonic()
        self.seg = {}                # stage -> (t_start, t_end)
        self.mem_bytes = 0           # staged bytes on the mem ledger


class _CudaDevOps:
    """Explicit h2d / compute / d2h legs on a CUDA device, one stream
    each. Each leg blocks its own pipeline thread until its work is done,
    which is what lets leg X of batch n overlap leg Y of batch m; the
    events also order the streams on the device."""

    #: free staging buffers kept per (shape, dtype)
    POOL_DEPTH = 4
    #: h2d stages into device memory (the staging_ring ledger)
    stages = True

    def __init__(self, device: torch.device):
        self.device = device
        self.copy_stream = torch.cuda.Stream(device)
        self.compute_stream = torch.cuda.Stream(device)
        self.d2h_stream = torch.cuda.Stream(device)
        self._lock = threading.Lock()
        self._free: dict = {}

    def _take(self, shape, dtype) -> tuple[torch.Tensor, bool]:
        with self._lock:
            free = self._free.get((shape, dtype))
            if free:
                buf = free.pop()
                PROFILER.mem_sub("donated_buffers", buf.nbytes)
                return buf, True
        return torch.empty(shape, dtype=dtype, device=self.device), False

    def release(self, buf: torch.Tensor) -> None:
        """Return a staging buffer whose consumer has finished."""
        with self._lock:
            free = self._free.setdefault((tuple(buf.shape), buf.dtype), [])
            if len(free) < self.POOL_DEPTH:
                free.append(buf)
                PROFILER.mem_add("donated_buffers", buf.nbytes)

    def close(self) -> None:
        """Drop the kept staging buffers, and their bytes off the ledger."""
        with self._lock:
            for free in self._free.values():
                for buf in free:
                    PROFILER.mem_sub("donated_buffers", buf.nbytes)
            self._free.clear()

    def h2d(self, host: np.ndarray):
        pinned = host_tensor(host).pin_memory()
        buf, reused = self._take(tuple(pinned.shape), pinned.dtype)
        with torch.cuda.stream(self.copy_stream):
            buf.copy_(pinned, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        ready.synchronize()
        return buf, ready, reused

    def run(self, fn, dev, ready):
        with torch.cuda.stream(self.compute_stream):
            self.compute_stream.wait_event(ready)
            out = fn(dev)
            done = torch.cuda.Event()
            done.record(self.compute_stream)
        done.synchronize()
        return out, done

    def adopt(self, fn) -> None:
        """Runs fn (the tier's device copies) on the d2h stream, which is
        already ordered after the dispatch's compute, and waits for the
        copies: the staged buffer may then go back to the pool."""
        with torch.cuda.stream(self.d2h_stream):
            fn()
            copied = torch.cuda.Event()
            copied.record(self.d2h_stream)
        copied.synchronize()

    def d2h(self, out, done):
        """The result in pinned host memory: a tensor, or every tensor of
        a fused output dict, copied on the d2h stream behind one event."""
        if not isinstance(out, (dict, torch.Tensor)):
            return np.asarray(out)
        with torch.cuda.stream(self.d2h_stream):
            self.d2h_stream.wait_event(done)
            host = pinned_copy(out)
            copied = torch.cuda.Event()
            copied.record(self.d2h_stream)
        copied.synchronize()
        return to_numpy(host)


class _HostDevOps:
    """The legs on the CPU device: the stages degenerate to plain calls."""

    stages = False

    def h2d(self, host: np.ndarray):
        return host_tensor(host), None, False

    def run(self, fn, x, ready):
        return fn(x), None

    def d2h(self, out, done):
        return to_numpy(out)

    def adopt(self, fn) -> None:
        fn()

    def release(self, buf) -> None:
        pass

    def close(self) -> None:
        pass


class _StageProf:
    """Per-stage wall-clock state machine: every instant a stage thread
    is in exactly one of busy (doing its leg's work) / idle (waiting on
    its upstream ring) / blocked (waiting to push downstream).  enter()
    folds the elapsed interval into the outgoing state's bucket;
    snapshot() is non-destructive and folds the in-progress interval
    in, so attribution is exact even mid-long-op."""

    __slots__ = ("lock", "acc", "state", "since")

    def __init__(self):
        self.lock = threading.Lock()
        self.acc = {s: 0.0 for s in _STATES}
        self.state = "idle"
        self.since = time.monotonic()

    def enter(self, state: str, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self.lock:
            self.acc[self.state] += max(0.0, now - self.since)
            self.state = state
            self.since = now

    def credit(self, state: str, seconds: float) -> None:
        """Direct accrual without a state switch (the depth-1 inline
        path, which runs every leg on the collector thread)."""
        with self.lock:
            self.acc[state] += max(0.0, seconds)

    def snapshot(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        with self.lock:
            acc = dict(self.acc)
            acc[self.state] += max(0.0, now - self.since)
        return acc

    def reset(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self.lock:
            for s in self.acc:
                self.acc[s] = 0.0
            self.since = now


class _RingQueue(queue.Queue):
    """Bounded stage ring with an occupancy time-integral: each mutation
    advances integral(qsize dt), so integral/wall is the ring's average
    occupancy over the profile window — the queue-theory complement to
    the stage state machine (a persistently full staging ring + an idle
    compute stage reads 'h2d-bound' before anyone eyeballs thread
    stacks).  _put/_get run under queue.Queue's own mutex."""

    def __init__(self, maxsize: int):
        super().__init__(maxsize)
        self._occ_integral = 0.0
        self._occ_t_last = time.monotonic()

    def _advance_locked(self, now: float) -> None:
        self._occ_integral += len(self.queue) \
            * max(0.0, now - self._occ_t_last)
        self._occ_t_last = now

    def _put(self, item) -> None:
        self._advance_locked(time.monotonic())
        super()._put(item)

    def _get(self):
        self._advance_locked(time.monotonic())
        return super()._get()

    def occupancy_integral(self) -> float:
        with self.mutex:
            self._advance_locked(time.monotonic())
            return self._occ_integral

    def occupancy_reset(self) -> None:
        with self.mutex:
            self._occ_integral = 0.0
            self._occ_t_last = time.monotonic()


class GpuDispatcher:
    """Coalesces same-key codec calls into single kernel launches and
    overlaps consecutive dispatches' h2d / compute / d2h legs.

    Key = (codec identity, kind, per-stripe shape): ops whose batches
    stack along axis 0 into one well-formed [S_total, k, chunk] call.

    Observability: a submitter's span (``trace``) grows a queue-delay
    child plus a device span split into h2d / compute / d2h segments,
    the measured stage intervals; the l_gpu_* PerfCounters aggregate the
    same segments, and the stage machines feed ``dispatch_profile()``.
    """

    def __init__(self, max_batch: int = 8, max_delay: float = 0.002,
                 tracer=None, pipeline_depth: int = 2, device=None):
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.tracer = tracer
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.queues: dict = {}     # key -> (fn, [_Pending], prefetch)
        self.stats = {"ops": 0, "dispatches": 0, "coalesced": 0}
        # per-codec throughput ledger: label -> {enc/dec bytes + a
        # bounded (t, kind, bytes) window for the rolling MB/s gauges}
        self.codec_stats: dict = {}
        self._telemetry_window = 10.0
        perf = (PerfCountersBuilder("osd_gpu")
                .add_time_avg("l_gpu_h2d",
                              "host->device transfer time")
                .add_time_avg("l_gpu_compute",
                              "device compute (stream synchronised)")
                .add_time_avg("l_gpu_d2h",
                              "device->host transfer time")
                .add_time_avg("l_gpu_dispatch_queue",
                              "op wait in the coalescing queue")
                .add_u64_counter("l_gpu_ops", "codec ops submitted")
                .add_u64_counter("l_gpu_dispatches",
                                 "kernel launches dispatched")
                .add_u64_counter("l_gpu_coalesced",
                                 "ops that shared a dispatch")
                .add_u64("l_gpu_queue_depth",
                         "ops waiting in the coalescing queues")
                .add_u64_counter("l_gpu_enc_bytes",
                                 "bytes through device encode")
                .add_u64_counter("l_gpu_dec_bytes",
                                 "bytes through device decode")
                .add_u64_counter("l_gpu_reused",
                                 "dispatches staged into a reused "
                                 "device buffer")
                .add_u64_counter("l_gpu_h2d_bytes",
                                 "bytes the h2d leg staged")
                .add_u64_counter("l_gpu_adopted",
                                 "results adopted into a device "
                                 "chunk tier")
                .add_u64_counter("l_gpu_adopt_failed",
                                 "adoptions the tier refused (the "
                                 "write itself succeeds)")
                .add_u64_counter("l_gpu_fused_dispatches",
                                 "fused write transforms dispatched")
                .add_u64_counter("l_gpu_fused_bytes_in",
                                 "raw bytes into the fused write "
                                 "transform")
                .add_u64_counter("l_gpu_fused_bytes_out",
                                 "stored+parity bytes out of the "
                                 "fused transform")
                .add_u64_counter("l_gpu_fused_compressed",
                                 "fused writes stored compressed")
                .add_u64_counter("l_gpu_fused_probe_rejects",
                                 "fused writes whose entropy probe "
                                 "rejected compression")
                .add_u64_avg("l_gpu_fused_ratio_milli",
                             "stored/raw size ratio per fused "
                             "write (x1000)"))
        # stall attribution: cumulative per-stage wall seconds in each
        # state, synced from the _StageProf machines by dispatch_profile
        for stage in _STAGES:
            for state in _STATES:
                perf.add_time("l_gpu_stage_%s_%s" % (stage, state),
                              "%s stage wall seconds %s" % (stage, state))
        self.perf = perf.create_perf_counters()
        # rolling dispatch-wall EWMA (submit -> results landed): the
        # straggler wait in _take_group scales its coalesce window from
        # this instead of always burning the full max_delay
        self._lat_ewma: float | None = None
        self._lat_alpha = 0.25
        self._devops = _CudaDevOps(self.device) \
            if self.device.type == "cuda" else _HostDevOps()
        # the fused-write ledger; every fused write takes a fresh key
        self._fused_seq = 0
        self.fused_stats = {"dispatches": 0, "bytes_in": 0,
                            "bytes_out": 0, "compressed": 0,
                            "probe_rejects": 0, "ratio_milli_sum": 0}
        # one state machine per pipeline stage plus the profile window's
        # anchor (profile_reset() restarts both)
        self._stage_prof = {s: _StageProf() for s in _STAGES}
        self._profile_t0 = time.monotonic()
        self._stop = False
        self._threads: list = []
        if self.pipeline_depth > 1:
            # the staging ring: bounded hand-off queues between stages;
            # the collector blocks when the ring is full.
            self._q_h2d: queue.Queue = _RingQueue(self.pipeline_depth)
            self._q_compute: queue.Queue = _RingQueue(self.pipeline_depth)
            self._q_d2h: queue.Queue = _RingQueue(self.pipeline_depth)
            for name, fn in (("gpu-h2d", self._h2d_loop),
                             ("gpu-compute", self._compute_loop),
                             ("gpu-d2h", self._d2h_loop)):
                t = threading.Thread(target=fn, name=name, daemon=True)
                t.start()
                self._threads.append(t)
        self._thread = threading.Thread(
            target=self._run, name="gpu-dispatch", daemon=True)
        self._thread.start()
        self._threads.append(self._thread)

    # -- public API ----------------------------------------------------

    @staticmethod
    def _codec_key(codec):
        """Identity BY VALUE: every PG backend holds its own codec
        instance, so keying on id() would never coalesce across PGs.
        Codecs with the same generator bitmatrix and packetsize compute
        the same function; the packetsize is part of the key because two
        packet-layout codecs of one bitmatrix and chunk size but another
        packetsize compute different functions."""
        cached = getattr(codec, "_dispatch_key", None)
        if cached is not None:
            return cached
        bm = getattr(codec, "_bitmat", None)
        if bm is not None:
            # full digest, not hash(): a 64-bit hash collision between
            # two generators of the same shape would silently coalesce
            # different codecs into one dispatch and return wrong bytes
            key = (type(codec).__name__, getattr(codec, "w", 0),
                   getattr(codec, "packetsize", 0), bm.shape,
                   hashlib.sha256(bm.tobytes()).digest())
        else:
            key = ("id", id(codec))
        try:
            codec._dispatch_key = key
        except AttributeError:
            pass
        return key

    @staticmethod
    def _codec_label(codec):
        """Stable human label for per-codec telemetry series: class name
        and layout params ("ReedSolomonVandermonde_k8m3")."""
        cached = getattr(codec, "_dispatch_label", None)
        if cached is not None:
            return cached
        label = type(codec).__name__
        try:
            k = codec.get_data_chunk_count()
            m = codec.get_chunk_count() - k
            label = "%s_k%dm%d" % (label, k, m)
        except Exception:
            pass
        try:
            codec._dispatch_label = label
        except AttributeError:
            pass
        return label

    def _account_codec(self, codec, kind: str, nbytes: int) -> None:
        now = time.monotonic()
        with self.lock:
            row = self.codec_stats.setdefault(
                self._codec_label(codec),
                {"enc_bytes": 0, "dec_bytes": 0, "window": deque()})
            row[kind + "_bytes"] += nbytes
            w = row["window"]
            w.append((now, kind, nbytes))
            cutoff = now - self._telemetry_window
            while w and w[0][0] < cutoff:
                w.popleft()
        self.perf.inc("l_gpu_%s_bytes" % kind, nbytes)

    def encode_async(self, codec, batch: np.ndarray, trace=NULL_SPAN,
                     resident=None) -> _Pending:
        """Async codec.encode_batch(batch): returns a future whose
        result() is the parity array. resident=(tier, key) asks the
        pipeline to adopt the staged data and computed parity into the
        device chunk tier."""
        key = (self._codec_key(codec), "enc", batch.shape[1:],
               str(batch.dtype))
        self._account_codec(codec, "enc", int(batch.nbytes))
        if resident is not None:
            resident = (resident[0], resident[1], codec)
        return self._submit_async(key, codec.encode_batch, batch, trace,
                                  resident=resident)

    def decode_async(self, codec, avail_rows: tuple,
                     chunks: np.ndarray, trace=NULL_SPAN) -> _Pending:
        """Async codec.decode_batch for one erasure signature; the
        decode table (inversion + device upload) is pre-staged in the
        pipeline's h2d stage so a fresh signature's table cost overlaps
        the previous dispatch's compute."""
        avail_rows = tuple(avail_rows)
        key = (self._codec_key(codec), "dec", avail_rows,
               chunks.shape[1:], str(chunks.dtype))
        self._account_codec(codec, "dec", int(chunks.nbytes))
        prefetch = None
        entry_fn = getattr(codec, "_decode_entry", None)
        if entry_fn is not None:
            def prefetch(avail=avail_rows, entry_fn=entry_fn):
                self._stage_entry(entry_fn(avail))
        return self._submit_async(
            key, lambda stacked: codec.decode_batch(avail_rows, stacked),
            chunks, trace, prefetch=prefetch)

    def repair_fraction_async(self, codec, target: int, chunks: np.ndarray,
                              trace=NULL_SPAN) -> _Pending:
        """Async codec.repair_fraction_batch: the helper-side projection
        of [B, chunk] survivor streams into [B, chunk/alpha] repair
        fractions for rebuilding `target`. The [1, alpha] projection's
        bitmatrix is pre-staged like a decode table; repair bytes count
        as decode traffic."""
        key = (self._codec_key(codec), "rfrac", target, chunks.shape[1:],
               str(chunks.dtype))
        self._account_codec(codec, "dec", int(chunks.nbytes))
        prefetch = None
        entry_fn = getattr(codec, "_fraction_entry", None)
        if entry_fn is not None:
            def prefetch(target=target, entry_fn=entry_fn):
                self._stage_entry(entry_fn(target))
        return self._submit_async(
            key, lambda stacked: codec.repair_fraction_batch(target, stacked),
            chunks, trace, prefetch=prefetch)

    def repair_combine_async(self, codec, target: int, helpers: tuple,
                             fractions: np.ndarray,
                             trace=NULL_SPAN) -> _Pending:
        """Async codec.repair_combine_batch: [B, d, sub] stacked helper
        fractions (rows in `helpers` order) -> rebuilt [B, chunk] target
        chunks, the combine matrix of (target, helpers) pre-staged in the
        h2d stage."""
        helpers = tuple(helpers)
        key = (self._codec_key(codec), "rcomb", target, helpers,
               fractions.shape[1:], str(fractions.dtype))
        self._account_codec(codec, "dec", int(fractions.nbytes))
        prefetch = None
        entry_fn = getattr(codec, "_combine_entry", None)
        if entry_fn is not None:
            def prefetch(target=target, helpers=helpers, entry_fn=entry_fn):
                self._stage_entry(entry_fn(target, helpers))
        return self._submit_async(
            key, lambda stacked: codec.repair_combine_batch(
                target, helpers, stacked),
            fractions, trace, prefetch=prefetch)

    def repair_fraction(self, codec, target: int, chunks: np.ndarray,
                        trace=NULL_SPAN) -> np.ndarray:
        """Blocking facade over repair_fraction_async."""
        return self.repair_fraction_async(codec, target, chunks,
                                          trace).result()

    def repair_combine(self, codec, target: int, helpers: tuple,
                       fractions: np.ndarray,
                       trace=NULL_SPAN) -> np.ndarray:
        """Blocking facade over repair_combine_async."""
        return self.repair_combine_async(codec, target, helpers, fractions,
                                         trace).result()

    def _stage_entry(self, entry: dict) -> None:
        """Stage a TableCache entry's bitmatrix onto this dispatcher's
        device (keyed per device, so a second dispatcher on another
        device stages its own copy instead of consuming the first's)."""
        if not (isinstance(entry, dict) and "bitmat" in entry):
            return
        devkey = device_entry_key(self.device)
        if devkey not in entry:
            entry.setdefault(
                devkey, host_tensor(entry["bitmat"]).to(self.device))

    def encode(self, codec, batch: np.ndarray, trace=NULL_SPAN,
               resident=None) -> np.ndarray:
        """codec.encode_batch(batch), coalesced across submitters — the
        blocking facade over encode_async."""
        return self.encode_async(codec, batch, trace,
                                 resident=resident).result()

    def decode(self, codec, avail_rows: tuple,
               chunks: np.ndarray, trace=NULL_SPAN) -> np.ndarray:
        """codec.decode_batch for one erasure signature, coalesced with
        ops sharing the same signature (same decode matrix)."""
        return self.decode_async(codec, avail_rows, chunks,
                                 trace).result()

    def fused_supported(self, codec) -> bool:
        """Whether whole-object writes through this codec can ride the
        fused write transform (an element-layout matrix codec)."""
        from . import fused_transform
        return fused_transform.fused_supported(codec)

    def fused_write_async(self, codec, batch: np.ndarray,
                          mode: str = "store",
                          required_ratio: float = 0.875,
                          entropy_max_bits: float = 7.0,
                          trace=NULL_SPAN, resident=None) -> _Pending:
        """Async fused write transform over one whole-object batch: one
        h2d, the transform's launches, one d2h of every output. The
        codec must live on this dispatcher's device. resident=(tier, key)
        adopts the stored rows, parity and shard crcs into the device
        chunk tier.

        Fused dispatches never coalesce across submitters (the
        compression decision and the shard crc chains are per object),
        but consecutive fused writes overlap through the pipeline
        stages. The future's result() is the fused host output dict
        (fused_transform.result_from_host builds a FusedResult)."""
        from . import fused_transform
        batch = np.asarray(batch)
        self._account_codec(codec, "enc", int(batch.nbytes))

        def fn(dev, _codec=codec, _mode=mode, _rr=required_ratio,
               _em=entropy_max_bits):
            return fused_transform.run_fused(
                _codec, None, mode=_mode, required_ratio=_rr,
                entropy_max_bits=_em, data_dev=dev)

        with self.lock:
            self._fused_seq += 1
            seq = self._fused_seq
        key = (self._codec_key(codec), "fused", mode, seq)
        if resident is not None:
            resident = (resident[0], resident[1], codec)
        return self._submit_async(key, fn, batch, trace, kind="fused",
                                  resident=resident)

    def fused_write(self, codec, batch: np.ndarray, mode: str = "store",
                    required_ratio: float = 0.875,
                    entropy_max_bits: float = 7.0, trace=NULL_SPAN,
                    resident=None):
        """Blocking facade over fused_write_async -> FusedResult."""
        from . import fused_transform
        batch = np.asarray(batch)
        S, k, chunk = batch.shape
        host = self.fused_write_async(
            codec, batch, mode=mode, required_ratio=required_ratio,
            entropy_max_bits=entropy_max_bits, trace=trace,
            resident=resident).result()
        return fused_transform.result_from_host(host, S, k, chunk, mode)

    def telemetry(self) -> dict:
        """The device-utilization gauge bag: live queue depth, lifetime
        coalescing ratio, the fused-write ledger and rolling per-codec
        encode/decode MB/s (bytes through the dispatcher over the last
        telemetry window)."""
        now = time.monotonic()
        with self.lock:
            depth = sum(len(e[1]) for e in self.queues.values())
            ops = self.stats["ops"]
            disp = self.stats["dispatches"]
            codecs = {}
            cutoff = now - self._telemetry_window
            for label, row in self.codec_stats.items():
                enc_b = dec_b = 0
                for t, kind, nb in row["window"]:
                    if t < cutoff:
                        continue
                    if kind == "enc":
                        enc_b += nb
                    else:
                        dec_b += nb
                codecs[label] = {
                    "enc_bytes": row["enc_bytes"],
                    "dec_bytes": row["dec_bytes"],
                    "enc_MBps": round(
                        enc_b / self._telemetry_window / 1e6, 3),
                    "dec_MBps": round(
                        dec_b / self._telemetry_window / 1e6, 3)}
        self.perf.set("l_gpu_queue_depth", depth)
        return {"queue_depth": depth,
                "device": device_label(self.device),
                "ops": ops, "dispatches": disp,
                "coalesce_ratio": round(disp / ops, 3) if ops else 1.0,
                "fused": self._fused_summary(),
                "codecs": codecs}

    def _fused_summary(self) -> dict:
        """The fused-write ledger: dispatch count, bytes through the
        fused program, compress decisions and the mean stored/raw
        ratio. Rides telemetry() and dispatch_status()."""
        with self.lock:
            st = dict(self.fused_stats)
        ratio_sum = st.pop("ratio_milli_sum")
        n = st["dispatches"]
        st["ratio_avg"] = round(ratio_sum / n / 1000.0, 4) if n else 1.0
        return st

    def dispatch_status(self) -> dict:
        """The `dispatch status` payload: pipeline shape, ring occupancy
        per stage, and the coalescing ledger. `donated_dispatches` reads
        ``l_gpu_reused``, the port's counterpart of the reference's
        donations."""
        ring = {"staging": 0, "computing": 0, "draining": 0}
        if self.pipeline_depth > 1:
            ring = {"staging": self._q_h2d.qsize(),
                    "computing": self._q_compute.qsize(),
                    "draining": self._q_d2h.qsize()}
        tel = self.telemetry()
        return {"pipeline_depth": self.pipeline_depth,
                "overlapped": self.pipeline_depth > 1,
                "device": tel["device"],
                "ring": ring,
                "queue_depth": tel["queue_depth"],
                "ops": tel["ops"],
                "dispatches": tel["dispatches"],
                "coalesce_ratio": tel["coalesce_ratio"],
                "lat_ewma_ms": round(self._lat_ewma * 1e3, 3)
                if self._lat_ewma is not None else None,
                "coalesce_wait_ms": round(
                    self._coalesce_wait() * 1e3, 3),
                "donated_dispatches": self.perf.get("l_gpu_reused"),
                "fused": tel["fused"],
                "segments_s": {
                    "h2d_avg": self.perf.avg("l_gpu_h2d"),
                    "compute_avg": self.perf.avg("l_gpu_compute"),
                    "d2h_avg": self.perf.avg("l_gpu_d2h"),
                    "queue_avg": self.perf.avg("l_gpu_dispatch_queue")},
                "profile": self.dispatch_profile()}

    def dispatch_profile(self) -> dict:
        """Stall attribution over the current profile window: per-stage
        busy/idle/blocked wall seconds and fractions, ring occupancy
        time-averages, and a one-line verdict.

        The verdict logic: the device stage with the highest busy
        fraction is the wall ("h2d-bound 71%") — unless no stage is
        busy even half the window AND the collector out-idles it, in
        which case the device isn't the problem, the feed is
        ("collector-starved 88%": submitters aren't producing work)."""
        now = time.monotonic()
        wall = max(1e-9, now - self._profile_t0)
        stages = {}
        for name, prof in self._stage_prof.items():
            acc = prof.snapshot(now)
            row = {}
            for state in _STATES:
                row[state + "_s"] = round(acc[state], 6)
                row[state + "_frac"] = round(
                    min(1.0, acc[state] / wall), 4)
            stages[name] = row
            # the cumulative counters follow each read of the profile
            for state in _STATES:
                self.perf.set("l_gpu_stage_%s_%s" % (name, state),
                              acc[state])
        occupancy = {"staging": 0.0, "computing": 0.0, "draining": 0.0}
        if self.pipeline_depth > 1:
            occupancy = {
                "staging": round(
                    self._q_h2d.occupancy_integral() / wall, 4),
                "computing": round(
                    self._q_compute.occupancy_integral() / wall, 4),
                "draining": round(
                    self._q_d2h.occupancy_integral() / wall, 4)}
        device = ("h2d", "compute", "d2h")
        bound = max(device, key=lambda s: stages[s]["busy_frac"])
        attribution = stages[bound]["busy_frac"]
        collector_idle = stages["collector"]["idle_frac"]
        if attribution < 0.5 and collector_idle > attribution:
            bound = "collector"
            attribution = collector_idle
            verdict = "collector-starved %d%%" \
                % round(collector_idle * 100)
        else:
            verdict = "%s-bound %d%%" % (bound,
                                         round(attribution * 100))
        return {"window_s": round(wall, 6),
                "verdict": verdict,
                "bound": bound,
                "attribution": attribution,
                "stages": stages,
                "queue_occupancy_avg": occupancy}

    def profile_reset(self) -> None:
        """Restart the attribution window (the `profile reset`
        surface)."""
        now = time.monotonic()
        for prof in self._stage_prof.values():
            prof.reset(now)
        self._profile_t0 = now
        if self.pipeline_depth > 1:
            self._q_h2d.occupancy_reset()
            self._q_compute.occupancy_reset()
            self._q_d2h.occupancy_reset()

    def shutdown(self) -> None:
        with self.cv:
            self._stop = True
            self.cv.notify_all()
        if self.pipeline_depth > 1:
            # a sentinel flushes the stage threads in order
            self._q_h2d.put(None)
        for t in self._threads:
            t.join(timeout=5)
        self._devops.close()

    # -- internals -----------------------------------------------------

    def _submit_async(self, key, fn, batch, trace=NULL_SPAN,
                      prefetch=None, kind="codec", resident=None
                      ) -> _Pending:
        p = _Pending(np.asarray(batch), trace, resident)
        with self.cv:
            q = self.queues.get(key)
            if q is None:
                q = self.queues[key] = (fn, [], prefetch, kind)
            q[1].append(p)
            self.stats["ops"] += 1
            depth = sum(len(e[1]) for e in self.queues.values())
            self.cv.notify_all()
        self.perf.set("l_gpu_queue_depth", depth)
        return p

    def _note_dispatch_wall(self, wall: float) -> None:
        """Fold one dispatch's submit->results wall into the latency
        EWMA the coalesce window scales from."""
        if wall <= 0:
            return
        # single writer per stage thread; a torn read in the window
        # heuristic only mis-sizes one wait, so no lock (and the
        # collector calls _coalesce_wait while HOLDING self.cv's lock)
        prev = self._lat_ewma
        self._lat_ewma = wall if prev is None \
            else (1.0 - self._lat_alpha) * prev + self._lat_alpha * wall

    def _coalesce_wait(self) -> float:
        """Adaptive straggler wait: half the rolling dispatch-wall EWMA,
        floored at max_delay/8 and capped at max_delay."""
        ewma = self._lat_ewma
        if ewma is None:
            return self.max_delay
        return min(self.max_delay, max(self.max_delay / 8.0, 0.5 * ewma))

    def _take_group(self):
        """Pick the fullest queue; wait up to the EWMA-scaled coalesce
        window for stragglers unless it is already at max_batch."""
        deadline = None
        while True:
            with self.cv:
                if self._stop:
                    return None
                best_key, best = None, None
                for key, entry in self.queues.items():
                    pend = entry[1]
                    if pend and (best is None or len(pend) > len(best[1])):
                        best_key, best = key, entry
                if best is None:
                    deadline = None
                    self.cv.wait(0.5)
                    continue
                if len(best[1]) >= self.max_batch or (
                        deadline is not None
                        and time.monotonic() >= deadline):
                    fn, pend, prefetch, kind = best
                    take = pend[:self.max_batch]
                    del pend[:len(take)]
                    if not pend:
                        self.queues.pop(best_key, None)
                    return _Dispatch(best_key, fn, take, prefetch, kind)
                wait = self._coalesce_wait()
                if deadline is None:
                    deadline = time.monotonic() + wait
                self.cv.wait(wait)

    def _instrumenting(self) -> bool:
        return self.tracer is not None and self.tracer.enabled

    def _run(self):
        """Collector: group submitters into fused dispatches and feed
        the pipeline (or, depth 1, run the synchronous loop)."""
        prof = self._stage_prof["collector"]
        while True:
            # idle = waiting for submitters (or stragglers): a starved
            # collector is the "upstream can't feed the device" verdict
            prof.enter("idle")
            d = self._take_group()
            if d is None:
                return
            prof.enter("busy")
            self.stats["dispatches"] += 1
            self.perf.inc("l_gpu_dispatches")
            self.perf.inc("l_gpu_ops", len(d.pend))
            if len(d.pend) > 1:
                self.stats["coalesced"] += len(d.pend)
                self.perf.inc("l_gpu_coalesced", len(d.pend))
            if self.pipeline_depth > 1:
                # blocks when the staging ring is full: that back-
                # pressure IS the depth-N bound
                prof.enter("blocked")
                self._q_h2d.put(d)
            else:
                self._dispatch_inline(d)

    @staticmethod
    def _stack(d: _Dispatch) -> np.ndarray:
        return d.pend[0].batch if len(d.pend) == 1 \
            else np.concatenate([p.batch for p in d.pend])

    # -- synchronous (depth-1) path -------------------------------------

    def _dispatch_inline(self, d: _Dispatch) -> None:
        t_start = time.monotonic()
        try:
            if d.prefetch is not None:
                d.prefetch()
            stacked = self._stack(d)
            self.perf.inc("l_gpu_h2d_bytes", int(stacked.nbytes))
            out, seg = device_segments(d.fn, stacked, self.device)
            self._slice_results(d, out)
            # the host arrays: the tier's upload is the object's crossing
            self._adopt_residents(d, stacked, out)
            t1 = t_start + seg["h2d"]
            t2 = t1 + seg["compute"]
            d.seg = {"h2d": (t_start, t1), "compute": (t1, t2),
                     "d2h": (t2, t2 + seg["d2h"])}
            self._account(d)
            if d.kind == "fused":
                self._account_fused(d)
            if self._instrumenting():
                # depth 1 runs every leg on the collector thread; the
                # per-stage machines never switch state, so credit the
                # measured legs directly, as the reference's
                # instrumented synchronous path does
                for stage in ("h2d", "compute", "d2h"):
                    a, b = d.seg[stage]
                    self._stage_prof[stage].credit("busy", b - a)
        except Exception as e:   # deliver, don't kill the loop
            for p in d.pend:
                p.error = e
        self._note_dispatch_wall(
            time.monotonic() - min(p.t_submit for p in d.pend))
        for p in d.pend:
            p.event.set()

    # -- pipelined stages ----------------------------------------------

    def _release(self, d: _Dispatch) -> None:
        """Hand the staging buffer back to the pool, and its bytes off
        the staging_ring ledger."""
        if d.dev is not None:
            self._devops.release(d.dev)
            d.dev = None
        if d.mem_bytes:
            PROFILER.mem_sub("staging_ring", d.mem_bytes)
            d.mem_bytes = 0

    def _fail(self, d: _Dispatch, e: BaseException) -> None:
        """Strict per-batch error propagation: the failed stage fails
        ONLY this fused batch's submitters; later batches proceed."""
        self._release(d)
        for p in d.pend:
            p.error = e
            p.event.set()

    def _h2d_loop(self) -> None:
        prof = self._stage_prof["h2d"]
        while True:
            prof.enter("idle")
            d = self._q_h2d.get()
            if d is None:
                self._q_compute.put(None)
                return
            prof.enter("busy")
            try:
                t0 = time.monotonic()
                stacked = self._stack(d)
                d.dev, d.ready, reused = self._devops.h2d(stacked)
                if self._devops.stages:
                    d.mem_bytes = int(stacked.nbytes)
                    PROFILER.mem_add("staging_ring", d.mem_bytes)
                self.perf.inc("l_gpu_h2d_bytes", int(stacked.nbytes))
                if reused:
                    self.perf.inc("l_gpu_reused")
                if d.prefetch is not None:
                    # decode-table staging rides the h2d stage: the
                    # inversion + bitmatrix upload of THIS dispatch
                    # overlap the PREVIOUS dispatch's compute
                    d.prefetch()
                d.seg["h2d"] = (t0, time.monotonic())
            except Exception as e:
                self._fail(d, e)
                continue
            prof.enter("blocked")
            self._q_compute.put(d)

    def _compute_loop(self) -> None:
        prof = self._stage_prof["compute"]
        while True:
            prof.enter("idle")
            d = self._q_compute.get()
            if d is None:
                self._q_d2h.put(None)
                return
            prof.enter("busy")
            try:
                t0 = time.monotonic()
                d.out_dev, d.done = self._devops.run(d.fn, d.dev, d.ready)
                d.seg["compute"] = (t0, time.monotonic())
            except Exception as e:
                self._fail(d, e)
                continue
            # compute has consumed the staged input: the next batch of
            # this shape is staged into it, unless the tier is still to
            # copy it (the d2h stage releases it then)
            if not any(p.resident is not None for p in d.pend):
                self._release(d)
            prof.enter("blocked")
            self._q_d2h.put(d)

    def _d2h_loop(self) -> None:
        prof = self._stage_prof["d2h"]
        while True:
            prof.enter("idle")
            d = self._q_d2h.get()
            if d is None:
                return
            prof.enter("busy")
            try:
                t0 = time.monotonic()
                out = self._devops.d2h(d.out_dev, d.done)
                d.seg["d2h"] = (t0, time.monotonic())
                self._slice_results(d, out)
                if d.dev is not None:
                    # the staged rows and the device outputs, copied on
                    # the device; then the staging buffer is free
                    self._devops.adopt(lambda: self._adopt_residents(
                        d, d.dev, d.out_dev))
                    self._release(d)
                d.out_dev = None
                self._account(d)
                if d.kind == "fused":
                    self._account_fused(d)
            except Exception as e:
                self._fail(d, e)
                continue
            self._note_dispatch_wall(
                time.monotonic() - min(p.t_submit for p in d.pend))
            for p in d.pend:
                p.event.set()

    def _slice_results(self, d: _Dispatch, out) -> None:
        if len(d.pend) == 1:
            d.pend[0].out = out
            return
        off = 0
        for p in d.pend:
            s = p.batch.shape[0]
            p.out = out[off:off + s]
            off += s

    def _adopt_residents(self, d: _Dispatch, data_src, out) -> None:
        """Hand the staged data rows and the computed outputs to the
        device chunk tier for every submitter that asked (device tensors
        when pipelined, host arrays at depth 1). Adoption failures never
        fail the submitter (the tier is a cache)."""
        if d.kind == "fused":
            # one submitter per fused dispatch (its key is unique): adopt
            # what was STORED, the compressed rows when the device chose
            # to compress, the staged raw rows when it chose store, and
            # keep the device-computed shard crcs beside them
            p = d.pend[0]
            if p.resident is None or not isinstance(p.out, dict):
                return
            tier, key, codec = p.resident
            host = p.out
            try:
                if "do_compress" in host:
                    used = int(host["used_stripes"])
                    rows, par = out["stored"][:used], out["parity"][:used]
                else:
                    rows = data_src
                    par = out["parity"][:data_src.shape[0]]
                tier.adopt_encode(
                    key, rows, par, codec,
                    digests=np.asarray(host["shard_crcs"], dtype=np.uint32))
                self.perf.inc("l_gpu_adopted")
            except Exception:
                self.perf.inc("l_gpu_adopt_failed")
            return
        off = 0
        for p in d.pend:
            s = p.batch.shape[0]
            if p.resident is not None:
                tier, key, codec = p.resident
                try:
                    tier.adopt_encode(key, data_src[off:off + s],
                                      out[off:off + s], codec)
                    self.perf.inc("l_gpu_adopted")
                except Exception:
                    self.perf.inc("l_gpu_adopt_failed")
            off += s

    def _account(self, d: _Dispatch) -> None:
        """Fold one dispatch's measured stage intervals into the l_gpu_*
        counters and back-fill queue/device spans under every
        participating op's trace (the segments are shared: a fused
        dispatch ran once for all of them)."""
        seg = d.seg
        h0, h1 = seg.get("h2d", (d.t_take, d.t_take))
        c0, c1 = seg.get("compute", (h1, h1))
        d0, d1 = seg.get("d2h", (c1, c1))
        self.perf.tinc("l_gpu_h2d", h1 - h0)
        self.perf.tinc("l_gpu_compute", c1 - c0)
        self.perf.tinc("l_gpu_d2h", d1 - d0)
        for p in d.pend:
            self.perf.tinc("l_gpu_dispatch_queue",
                           max(0.0, d.t_take - p.t_submit))
            if not p.trace.valid():
                continue
            p.trace.child_interval("gpu_queue", p.t_submit, d.t_take)
            dev = p.trace.child_interval(
                "gpu_device", h0, d1,
                batch=int(sum(q.batch.shape[0] for q in d.pend)),
                coalesced=len(d.pend))
            dev.child_interval("h2d", h0, h1)
            dev.child_interval("compute", c0, c1)
            dev.child_interval("d2h", d0, d1)

    def _account_fused(self, d: _Dispatch) -> None:
        """Fold one fused write's outcome into the l_gpu_fused_* counters
        and the fused_stats bag."""
        p = d.pend[0]
        host = p.out
        raw = int(p.batch.nbytes)
        compressed = bool(host.get("do_compress", False))
        stored = int(host["comp_len"]) if compressed else raw
        par = host["parity"]
        m_chunk = int(par.shape[1]) * int(par.shape[2])
        stripes = int(host["used_stripes"]) if "used_stripes" in host \
            else int(p.batch.shape[0])
        out_bytes = stored + stripes * m_chunk
        probe_reject = "probe_ok" in host and not bool(host["probe_ok"])
        ratio_milli = (stored * 1000) // raw if raw else 1000
        self.perf.inc("l_gpu_fused_dispatches")
        self.perf.inc("l_gpu_fused_bytes_in", raw)
        self.perf.inc("l_gpu_fused_bytes_out", out_bytes)
        if compressed:
            self.perf.inc("l_gpu_fused_compressed")
        if probe_reject:
            self.perf.inc("l_gpu_fused_probe_rejects")
        self.perf.tinc("l_gpu_fused_ratio_milli", ratio_milli)
        with self.lock:
            st = self.fused_stats
            st["dispatches"] += 1
            st["bytes_in"] += raw
            st["bytes_out"] += out_bytes
            st["compressed"] += int(compressed)
            st["probe_rejects"] += int(probe_reject)
            st["ratio_milli_sum"] += ratio_milli
