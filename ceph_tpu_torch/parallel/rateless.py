"""Rateless straggler-proof dispatch over a list of devices.

Port of ``ceph_tpu/parallel/rateless.py`` (PAPERS.md "Rateless Codes
for Near-Perfect Load Balancing in Distributed Matrix-Vector
Multiplication", arXiv:1804.10331). Instead of one fixed shard per
device, where the slowest device gates every batch, a bulk job is cut
into ``factor * n_devices`` micro-batches on a shared work queue that
idle devices pull from. A slow device takes fewer micro-batches; the job
ends when enough work is done, not when the slowest device is.

Three robustness layers ride the queue:

  work stealing     every worker pulls from the one shared deque; the
                    "stolen" counter counts micro-batches completed by a
                    device other than their fixed-shard home
                    (seq % n_devices).
  speculation       each micro-batch carries a deadline derived from the
                    executing device's rolling latency EWMA
                    (``osd_mesh_microbatch_timeout_ms`` pins it instead
                    when > 0). An overdue micro-batch is re-dispatched to
                    another device; first result wins, duplicates are
                    discarded by seq. Duplicated in-flight buffers are
                    accounted in the profiler's memory ledger under
                    "speculative_buffers".
  blacklist         repeated timeouts or errors move a device to a
                    blacklist; its in-flight work drains back to the
                    queue, so the job degrades to n-1 devices without
                    failing. Probation re-admits it after an exponential
                    backoff with ONE canary micro-batch. `degraded()`
                    counts the blacklisted devices.

LT-coded decode (`map_batch_coded`) also dispatches XORs of source
micro-batches: every GF(2) matrix product is linear, so a coded
micro-batch's result is the XOR of its sources' results, and a peeling
pass seals the job once any sufficient subset has landed.

`DeviceFaultSet` injects device faults (stall-by-ms, fail-next-N,
flaky-rate, kill/revive per device index) deterministically.

The PyTorch idiom: one worker thread per entry of ``devices`` (which may
repeat a device: ``["cuda:0"] * 4`` on one card, ``["cpu"] * 8`` in the
tests). Each worker makes its device current and, on CUDA, runs on a
stream of its own, so the kernel wrappers (which launch on the current
stream) of N workers on one card overlap. A micro-batch is a contiguous
slice of the host batch along axis 0; the worker copies it to its device,
calls ``fn`` on that tensor there, and brings the result back to the host
(that copy ends the micro-batch's wall time, so the latency EWMA sees the
device's work). The codec conveniences run the codec's tensor path, which
runs where its tensor lies and keeps the codec's bitmatrices per device.
With every worker killed, the caller's thread runs the rest of its job
on the job's home device (the codec's own device), never on the CPU
unless that is the codec's device.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque

import numpy as np
import torch

from ..common.profiler import PROFILER
from ..device import device_label, resolve_device
from .placement import _local_devices, local_device_count

__all__ = ["RatelessDispatcher", "DeviceFaultSet", "DeviceKilled",
           "DEVICE_FAULTS", "get_dispatcher", "set_dispatcher",
           "set_enabled", "reset_dispatcher"]


class DeviceKilled(RuntimeError):
    """The fault injector killed this device mid-operation."""


class DeviceFaultSet:
    """Deterministic device fault injection; the worker loop consults it
    around every micro-batch.

      stall_ms(idx, ms)    every micro-batch on device idx sleeps ms
                           before running (a consistently slow device)
      fail_next(idx, n)    the next n micro-batches on idx raise
      flaky(idx, one_in)   1-in-N micro-batches on idx raise, selected
                           by a seeded hash of (seed, idx, seq): the SAME
                           seqs fail every run with the same seed
      kill(idx)            the device is dead: in-flight work drains back
                           to the queue, future pulls are refused
      revive(idx)          lift the kill (probation re-admits it)
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._lock = threading.Lock()
        self._stall_ms: dict = {}     # idx -> ms
        self._fail_next: dict = {}    # idx -> remaining count
        self._flaky: dict = {}        # idx -> one_in
        self._killed: set = set()

    # -- knobs ----------------------------------------------------------

    def stall_ms(self, idx: int, ms: float) -> None:
        with self._lock:
            if ms > 0:
                self._stall_ms[idx] = float(ms)
            else:
                self._stall_ms.pop(idx, None)

    def fail_next(self, idx: int, count: int = 1) -> None:
        with self._lock:
            self._fail_next[idx] = int(count)

    def flaky(self, idx: int, one_in: int) -> None:
        with self._lock:
            if one_in > 0:
                self._flaky[idx] = int(one_in)
            else:
                self._flaky.pop(idx, None)

    def kill(self, idx: int) -> None:
        with self._lock:
            self._killed.add(idx)

    def revive(self, idx: int) -> None:
        with self._lock:
            self._killed.discard(idx)

    def clear_all(self) -> None:
        with self._lock:
            self._stall_ms.clear()
            self._fail_next.clear()
            self._flaky.clear()
            self._killed.clear()

    # -- worker-loop hooks ----------------------------------------------

    def is_killed(self, idx: int) -> bool:
        with self._lock:
            return idx in self._killed

    def stall_for(self, idx: int) -> float:
        """Seconds this device must stall before running (0 = none)."""
        with self._lock:
            return self._stall_ms.get(idx, 0.0) / 1e3

    def check(self, idx: int, seq: int) -> None:
        """Raise for an injected failure of micro-batch `seq` on device
        `idx` (called by the worker before running it)."""
        with self._lock:
            if idx in self._killed:
                raise DeviceKilled("device %d is killed" % idx)
            n = self._fail_next.get(idx, 0)
            if n > 0:
                if n == 1:
                    del self._fail_next[idx]
                else:
                    self._fail_next[idx] = n - 1
                raise RuntimeError(
                    "injected device failure on device %d" % idx)
            one_in = self._flaky.get(idx, 0)
        if one_in > 0:
            h = hashlib.sha1(repr(
                (self.seed, idx, seq)).encode()).digest()
            if int.from_bytes(h[:8], "little") % one_in == 0:
                raise RuntimeError(
                    "injected flaky failure (1-in-%d) on device %d "
                    "seq %d" % (one_in, idx, seq))

    def empty(self) -> bool:
        with self._lock:
            return not (self._stall_ms or self._fail_next
                        or self._flaky or self._killed)


DEVICE_FAULTS = DeviceFaultSet()


# -- health states ------------------------------------------------------

_HEALTHY, _PROBATION, _BLACKLISTED = "healthy", "probation", "blacklisted"


class _DeviceHealth:
    """Per-worker latency EWMA + blacklist/probation state machine.
    All transitions run under the dispatcher's lock."""

    def __init__(self, idx: int, device, label: str):
        self.idx = idx
        self.device = device
        self.label = label
        self.state = _HEALTHY
        self.ewma_s: float | None = None   # rolling per-micro-batch wall
        self.strikes = 0                   # consecutive timeouts/errors
        self.backoffs = 0                  # blacklist episodes (backoff)
        self.blacklist_until = 0.0         # clock() of probation entry
        self.canary_seq: int | None = None  # the probation micro-batch
        # counters (mesh status)
        self.completed = 0
        self.stolen = 0
        self.redispatched = 0              # speculations AGAINST this dev
        self.timeouts = 0
        self.errors = 0
        self.inflight = 0
        self.blacklist_total = 0

    def record_latency(self, dt: float, alpha: float) -> None:
        self.ewma_s = dt if self.ewma_s is None \
            else (1.0 - alpha) * self.ewma_s + alpha * dt

    def status(self) -> dict:
        return {"device": self.label,
                "state": self.state,
                "ewma_ms": round(self.ewma_s * 1e3, 3)
                if self.ewma_s is not None else None,
                "inflight": self.inflight,
                "completed": self.completed,
                "stolen": self.stolen,
                "redispatched": self.redispatched,
                "timeouts": self.timeouts,
                "errors": self.errors,
                "blacklisted": self.state == _BLACKLISTED,
                "probation": self.state == _PROBATION,
                "blacklist_total": self.blacklist_total}


class _Item:
    """One micro-batch on the queue: seq identifies it within its job
    (first result wins; late copies are discarded by seq)."""

    __slots__ = ("job", "seq", "data", "attempt", "speculative")

    def __init__(self, job, seq, data, attempt=0, speculative=False):
        self.job = job
        self.seq = seq
        self.data = data
        self.attempt = attempt
        self.speculative = speculative


class _Job:
    """A bulk op cut into micro-batches. `results` is keyed by seq; coded
    jobs (LT) also carry equations and may seal before every item lands.
    `home` is the device the caller's thread runs leftovers on."""

    def __init__(self, fn, total: int, home: torch.device, coded=None):
        self.fn = fn
        self.total = total
        self.home = home
        self.results: dict = {}       # seq -> ndarray (source results)
        self.coded = coded            # seq -> frozenset(source seqs)
        self.equations: list = []     # pending (set(seqs), ndarray)
        self.cv = threading.Condition()
        self.done = False
        self.error: BaseException | None = None
        self.duplicates = 0
        # seq -> list of (health, t_start, deadline_s, data) live attempts
        self.inflight: dict = {}
        # seq -> duplicated buffer bytes charged to the speculative
        # ledger, released exactly once when the seq seals (whichever
        # copy wins) or the job is forgotten
        self.spec_seqs: dict = {}

    def sealed(self) -> bool:
        return self.done or len(self.results) >= self.total


def _host(batch) -> np.ndarray:
    if isinstance(batch, torch.Tensor):
        return batch.cpu().numpy()
    return np.asarray(batch)


def _call(fn, data: np.ndarray, device: torch.device, stream=None):
    """fn on `data` copied to `device` (on `stream`, current for this
    thread, on CUDA), its result copied back to the host."""
    a = np.ascontiguousarray(data)
    if not a.flags.writeable:
        a = a.copy()
    if device.type != "cuda":
        return _host(fn(torch.from_numpy(a).to(device)))
    with torch.cuda.device(device), torch.cuda.stream(stream):
        return _host(fn(torch.from_numpy(a).to(device)))


class RatelessDispatcher:
    """Shared micro-batch work queue over a list of devices.

    `map_batch(fn, batch)` splits `batch` along axis 0 into about
    `factor * n_devices` contiguous micro-batches, runs each through `fn`
    on whichever worker pulls it first, and reassembles the outputs in
    order: bit-identical to `fn(batch)` for any batch-elementwise fn
    (every codec batch call is).

    devices: None means the visible CUDA devices (raising where there
    are none); an explicit list may repeat a device.
    """

    def __init__(self, devices=None, factor: int = 4,
                 timeout_ms: float = 0.0, ewma_alpha: float = 0.25,
                 deadline_mult: float = 4.0,
                 deadline_floor_ms: float = 20.0,
                 blacklist_strikes: int = 3,
                 probation_base_s: float = 0.05,
                 probation_max_s: float = 5.0,
                 clock=None, injector=None, name: str = "rateless"):
        if devices is None:
            devices = _local_devices()
            if not devices:
                raise RuntimeError(
                    "CUDA is not available; pass devices=[...] (for "
                    "example ['cpu'] * 4) to dispatch on the host")
        self.devices = [resolve_device(d) for d in devices]
        self.factor = max(1, int(factor))
        self.timeout_s = float(timeout_ms) / 1e3
        self.ewma_alpha = float(ewma_alpha)
        self.deadline_mult = float(deadline_mult)
        self.deadline_floor_s = float(deadline_floor_ms) / 1e3
        self.blacklist_strikes = max(1, int(blacklist_strikes))
        self.probation_base_s = float(probation_base_s)
        self.probation_max_s = float(probation_max_s)
        self.clock = clock if clock is not None else time.monotonic
        self.injector = injector if injector is not None \
            else DEVICE_FAULTS
        self.cv = threading.Condition()
        self.queue: deque = deque()
        self.health = [_DeviceHealth(i, d, device_label(d))
                       for i, d in enumerate(self.devices)]
        self.redispatch_total = 0
        self.stolen_total = 0
        self.duplicate_total = 0
        self._spec_bytes = 0          # live duplicated buffers (ledger)
        self._stop = False
        self._threads = [
            threading.Thread(target=self._worker, args=(i,),
                             name="%s-%d" % (name, i), daemon=True)
            for i in range(len(self.devices))]
        for t in self._threads:
            t.start()

    # -- public API -----------------------------------------------------

    def map_batch(self, fn, batch, micro: int | None = None, *,
                  home=None):
        """Run `fn` over `batch` (split along axis 0) through the shared
        queue; returns np.concatenate of the per-micro-batch outputs in
        order, bit-identical to fn(batch). `fn` takes a tensor on the
        worker's device. `home` (default: the first device) is where the
        caller's thread runs a batch too small to split, or the rest of
        the job when every worker is killed."""
        batch = _host(batch)
        home = self.devices[0] if home is None else torch.device(home)
        items = self._split(batch, micro) if batch.shape[0] else []
        if len(items) <= 1:
            # nothing to steal; skip the queue round-trip
            return _call(fn, batch, home)
        job = _Job(fn, len(items), home)
        self._enqueue_job(job, items)
        self._wait(job)
        return np.concatenate([job.results[s]
                               for s in range(job.total)], axis=0)

    def map_batch_coded(self, fn, batch, micro: int | None = None,
                        overhead: int | None = None, seed: int = 0, *,
                        home=None):
        """LT-coded variant for LINEAR fns (every GF(2) matrix product
        is: fn(a ^ b) == fn(a) ^ fn(b)). Beyond the N source
        micro-batches, `overhead` coded micro-batches (XORs of seeded
        random source subsets) ride the queue; a peeling pass seals the
        job as soon as ANY sufficient subset of results lands."""
        batch = _host(batch)
        home = self.devices[0] if home is None else torch.device(home)
        items = self._split(batch, micro) if batch.shape[0] else []
        n = len(items)
        if n <= 1:
            return _call(fn, batch, home)
        if overhead is None:
            overhead = max(1, n // 4)
        # coded micro-batches need equal-shaped sources to XOR: pad the
        # tail slice with zero rows (linear => zero rows yield zero
        # output rows; the tail result is trimmed on reassembly)
        shape0 = items[0][1].shape[0]
        sizes = [d.shape[0] for _s, d in items]
        padded = []
        for seq, data in items:
            if data.shape[0] < shape0:
                pad = np.zeros((shape0 - data.shape[0],)
                               + data.shape[1:], dtype=data.dtype)
                data = np.concatenate([data, pad], axis=0)
            padded.append((seq, data))
        rng = np.random.default_rng(seed)
        coded: dict = {}
        citems = []
        for j in range(overhead):
            deg = int(rng.integers(2, min(n, 4) + 1))
            src = sorted(rng.choice(n, size=deg, replace=False))
            acc = padded[src[0]][1].copy()
            for s in src[1:]:
                np.bitwise_xor(acc, padded[s][1], out=acc)
            coded[n + j] = frozenset(int(s) for s in src)
            citems.append((n + j, acc))
        job = _Job(fn, n, home, coded=coded)
        self._enqueue_job(job, padded + citems)
        self._wait(job)
        return np.concatenate(
            [job.results[s][:sizes[s]] for s in range(n)], axis=0)

    # codec-shaped conveniences (the ec_util / crush integration seams):
    # each micro-batch is a tensor on its worker's device, so the codec's
    # tensor path runs there

    @staticmethod
    def _home(codec):
        return getattr(codec, "device", None)

    def encode(self, codec, batch):
        return self.map_batch(lambda b: codec.encode_batch(b), batch,
                              home=self._home(codec))

    def decode(self, codec, avail_rows, chunks, lt: bool = False,
               seed: int = 0):
        avail_rows = tuple(avail_rows)
        fn = lambda b: codec.decode_batch(avail_rows, b)  # noqa: E731
        if lt:
            return self.map_batch_coded(fn, chunks, seed=seed,
                                        home=self._home(codec))
        return self.map_batch(fn, chunks, home=self._home(codec))

    def repair_combine(self, codec, target, helpers, fractions):
        helpers = tuple(helpers)
        return self.map_batch(
            lambda b: codec.repair_combine_batch(target, helpers, b),
            fractions, home=self._home(codec))

    # -- introspection --------------------------------------------------

    def device_status(self) -> list:
        with self.cv:
            return [h.status() for h in self.health]

    def status(self) -> dict:
        with self.cv:
            degraded = sum(1 for h in self.health
                           if h.state == _BLACKLISTED)
            return {"n_devices": len(self.devices),
                    "microbatch_factor": self.factor,
                    "queue_depth": len(self.queue),
                    "redispatch_total": self.redispatch_total,
                    "stolen_total": self.stolen_total,
                    "duplicate_total": self.duplicate_total,
                    "blacklisted": degraded,
                    "blacklist_total": sum(h.blacklist_total
                                           for h in self.health),
                    "devices": [h.status() for h in self.health]}

    def degraded(self) -> int:
        """Count of currently-blacklisted devices."""
        with self.cv:
            return sum(1 for h in self.health
                       if h.state == _BLACKLISTED)

    def shutdown(self) -> None:
        with self.cv:
            self._stop = True
            self.cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)

    # -- internals ------------------------------------------------------

    def _split(self, batch, micro):
        if micro is None:
            micro = self.factor * len(self.devices)
        micro = max(1, min(int(micro), batch.shape[0]))
        bounds = np.linspace(0, batch.shape[0], micro + 1).astype(int)
        return [(seq, batch[bounds[seq]:bounds[seq + 1]])
                for seq in range(micro)
                if bounds[seq + 1] > bounds[seq]]

    def _enqueue_job(self, job, items) -> None:
        with self.cv:
            for seq, data in items:
                self.queue.append(_Item(job, seq, data))
            self.cv.notify_all()

    def _deadline_s(self, health) -> float:
        if self.timeout_s > 0:
            return self.timeout_s
        if health.ewma_s is None:
            return float("inf")       # no sample yet: no speculation
        return max(self.deadline_floor_s,
                   self.deadline_mult * health.ewma_s)

    def _wait(self, job: _Job) -> None:
        """Caller-side wait + deadline monitor: while the job is open,
        scan its in-flight attempts against the (injectable) clock and
        speculatively re-dispatch overdue micro-batches. Clock reads
        drive every deadline decision, so a fake clock makes the whole
        speculation path deterministic (the cv.wait below only paces the
        polling, never the verdict)."""
        while True:
            with job.cv:
                if job.sealed() or job.error is not None:
                    break
                job.cv.wait(0.002)
                if job.sealed() or job.error is not None:
                    break
            self._check_deadlines(job)
            self._host_fallback(job)
        with job.cv:
            job.done = True
        self._forget_job(job)
        if job.error is not None:
            raise job.error

    def _check_deadlines(self, job: _Job) -> None:
        now = self.clock()
        overdue = []
        with self.cv:
            with job.cv:
                for seq, attempts in job.inflight.items():
                    if seq in job.results:
                        continue
                    live = [a for a in attempts if a[2] is not None]
                    if not live:
                        continue
                    if all(now - t0 >= dl for _h, t0, dl, _d in live) \
                            and len(attempts) < len(self.devices):
                        overdue.append(seq)
            for seq in overdue:
                self._speculate_locked(job, seq)

    def _host_fallback(self, job: _Job) -> None:
        """Degenerate survival path: with EVERY worker killed, nothing
        will ever pull the queue, so this job's remaining micro-batches
        run on the caller's thread, on the job's home device."""
        with self.cv:
            if not all(self.injector.is_killed(h.idx)
                       for h in self.health):
                return
            mine, keep = [], deque()
            for it in self.queue:
                (mine if it.job is job else keep).append(it)
            self.queue = keep
        for it in mine:
            with job.cv:
                if job.sealed() or it.seq in job.results:
                    continue
            try:
                out = _call(job.fn, it.data, job.home)
            except BaseException as e:
                with job.cv:
                    job.error = e
                    job.cv.notify_all()
                return
            self._complete(job, it.seq, out)

    def _speculate_locked(self, job: _Job, seq: int) -> None:
        """Re-dispatch one overdue micro-batch (dispatcher lock held):
        push a copy to the queue for any healthy device to steal, strike
        the stragglers, account the duplicated buffer."""
        for it in self.queue:
            if it.job is job and it.seq == seq:
                return                # already requeued (drain path)
        with job.cv:
            attempts = job.inflight.get(seq, [])
            if not attempts or seq in job.results:
                return
            data = attempts[-1][3]
            for h, _t0, _dl, _d in attempts:
                h.timeouts += 1
                h.redispatched += 1
                self._strike_locked(h)
        self.redispatch_total += 1
        PROFILER.mem_add("speculative_buffers", data.nbytes)
        self._spec_bytes += data.nbytes
        with job.cv:
            job.spec_seqs[seq] = job.spec_seqs.get(seq, 0) + data.nbytes
        self.queue.append(_Item(job, seq, data, speculative=True))
        self.cv.notify_all()

    def _strike_locked(self, h: _DeviceHealth) -> None:
        h.strikes += 1
        if h.state != _BLACKLISTED \
                and h.strikes >= self.blacklist_strikes:
            self._blacklist_locked(h)

    def _blacklist_locked(self, h: _DeviceHealth) -> None:
        h.state = _BLACKLISTED
        h.blacklist_total += 1
        h.backoffs += 1
        h.canary_seq = None
        backoff = min(self.probation_max_s,
                      self.probation_base_s * (2 ** (h.backoffs - 1)))
        h.blacklist_until = self.clock() + backoff
        self.cv.notify_all()

    def _forget_job(self, job: _Job) -> None:
        """Drop a finished job's leftovers from the queue (cancelled
        speculative copies, coded extras) and release whatever
        speculative-ledger bytes its sealed seqs did not already
        return (a job that errored out mid-speculation)."""
        with self.cv:
            self.queue = deque(it for it in self.queue if it.job is not job)
        with job.cv:
            leftover = sum(job.spec_seqs.values())
            job.spec_seqs.clear()
        if leftover:
            self._release_spec(leftover)

    def _release_spec(self, nbytes: int) -> None:
        with self.cv:
            nbytes = min(nbytes, self._spec_bytes)
            if nbytes <= 0:
                return
            self._spec_bytes -= nbytes
        PROFILER.mem_sub("speculative_buffers", nbytes)

    # -- worker side ----------------------------------------------------

    def _next_item(self, idx: int):
        """Blocking pull honoring the health state machine: healthy
        devices take the queue head; a blacklisted device waits out its
        backoff, then takes ONE canary micro-batch (probation)."""
        h = self.health[idx]
        while True:
            with self.cv:
                if self._stop:
                    return None
                if self.injector.is_killed(idx):
                    if h.state != _BLACKLISTED:
                        self._blacklist_locked(h)
                    self.cv.wait(0.01)
                    continue
                if h.state == _BLACKLISTED:
                    if self.clock() >= h.blacklist_until and self.queue:
                        it = self.queue.popleft()
                        h.state = _PROBATION
                        h.canary_seq = it.seq
                        self._note_pull_locked(h, it)
                        return it
                    self.cv.wait(0.01)
                    continue
                if h.state == _PROBATION and h.canary_seq is not None:
                    # one canary at a time: wait for its verdict
                    self.cv.wait(0.01)
                    continue
                if self.queue:
                    it = self.queue.popleft()
                    self._note_pull_locked(h, it)
                    return it
                self.cv.wait(0.05)

    def _note_pull_locked(self, h: _DeviceHealth, it: _Item) -> None:
        h.inflight += 1
        t0 = self.clock()
        dl = self._deadline_s(h)
        with it.job.cv:
            it.job.inflight.setdefault(it.seq, []).append(
                (h, t0, None if dl == float("inf") else dl, it.data))

    def _run_item(self, idx: int, it: _Item, stream):
        stall = self.injector.stall_for(idx)
        if stall > 0:
            time.sleep(stall)
        self.injector.check(idx, it.seq)
        return _call(it.job.fn, it.data, self.devices[idx], stream)

    def _worker(self, idx: int) -> None:
        dev = self.devices[idx]
        stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" \
            else None
        while True:
            it = self._next_item(idx)
            if it is None:
                return
            t0 = self.clock()
            try:
                out = self._run_item(idx, it, stream)
            except DeviceKilled:
                self._drain(idx, it)
                continue
            except BaseException as e:
                self._on_error(idx, it, e)
                continue
            self._on_result(idx, it, out, self.clock() - t0)

    def _drain(self, idx: int, it: _Item) -> None:
        """A dead device's in-flight micro-batch goes straight back to
        the queue: zero lost micro-batches, the job completes on the
        surviving n-1 devices."""
        h = self.health[idx]
        with self.cv:
            h.inflight = max(0, h.inflight - 1)
            if h.state != _BLACKLISTED:
                self._blacklist_locked(h)
            h.canary_seq = None
            with it.job.cv:
                done = it.seq in it.job.results or it.job.done
                it.job.inflight[it.seq] = [
                    a for a in it.job.inflight.get(it.seq, [])
                    if a[0] is not h]
            if not done:
                requeued = any(q.job is it.job and q.seq == it.seq
                               for q in self.queue)
                if not requeued:
                    self.queue.append(
                        _Item(it.job, it.seq, it.data,
                              attempt=it.attempt + 1,
                              speculative=it.speculative))
            self.cv.notify_all()

    def _on_error(self, idx: int, it: _Item, err: BaseException) -> None:
        h = self.health[idx]
        with self.cv:
            h.inflight = max(0, h.inflight - 1)
            h.errors += 1
            if h.state == _PROBATION and h.canary_seq == it.seq:
                # failed canary: back to the blacklist, doubled backoff
                h.canary_seq = None
                self._blacklist_locked(h)
            else:
                self._strike_locked(h)
            with it.job.cv:
                done = it.seq in it.job.results or it.job.done
                it.job.inflight[it.seq] = [
                    a for a in it.job.inflight.get(it.seq, [])
                    if a[0] is not h]
                others = bool(it.job.inflight[it.seq])
            healthy = any(x.state == _HEALTHY for x in self.health)
            requeued = any(q.job is it.job and q.seq == it.seq
                           for q in self.queue)
            if not done and not others and not requeued:
                if healthy or it.attempt < 2 * len(self.devices):
                    self.queue.append(
                        _Item(it.job, it.seq, it.data,
                              attempt=it.attempt + 1,
                              speculative=it.speculative))
                else:
                    # every device is striking out: surface the error
                    # instead of spinning forever
                    with it.job.cv:
                        it.job.error = err
                        it.job.cv.notify_all()
            self.cv.notify_all()

    def _on_result(self, idx: int, it: _Item, out, dt: float) -> None:
        h = self.health[idx]
        job = it.job
        with self.cv:
            h.inflight = max(0, h.inflight - 1)
            # lateness is judged against the deadline BEFORE this sample
            # updates the EWMA; the sample is then always recorded, late
            # or not: straggling is punished by the deadline monitor,
            # while the EWMA tracks what the environment delivers, so a
            # global slowdown stretches every deadline instead of
            # blacklisting every device
            dl = self._deadline_s(h)
            late = dl != float("inf") and dt >= dl
            h.record_latency(dt, self.ewma_alpha)
            if h.state == _PROBATION and h.canary_seq == it.seq:
                # the canary answered: re-admitted (an erroring or
                # killed canary re-blacklists via _on_error/_drain)
                h.canary_seq = None
                h.state = _HEALTHY
                h.strikes = 0
            elif h.state == _HEALTHY:
                # a late success neither strikes (the overdue deadline
                # already did) nor re-earns trust
                if not late:
                    h.strikes = 0
            h.completed += 1
            if it.seq % len(self.devices) != idx:
                h.stolen += 1
                self.stolen_total += 1
            accepted = self._complete(job, it.seq, out)
            if not accepted:
                self.duplicate_total += 1
                with job.cv:
                    job.duplicates += 1
            self.cv.notify_all()

    def _complete(self, job: _Job, seq: int, out) -> bool:
        """First result wins (duplicates discarded by seq); coded results
        feed the peeling decoder. Sealing a seq returns its
        speculative-ledger bytes whichever copy won the race."""
        spec_release = 0
        accepted = False
        with job.cv:
            if job.done:
                pass
            elif job.coded is not None and seq >= job.total:
                srcs = job.coded[seq]
                if not srcs <= set(job.results):
                    job.equations.append((set(srcs), out))
                    self._peel(job)
                    accepted = True
            elif seq not in job.results:
                job.results[seq] = out
                if job.coded is not None:
                    self._peel(job)
                accepted = True
            if accepted:
                spec_release = job.spec_seqs.pop(seq, 0)
                job.inflight.pop(seq, None)
                if job.sealed():
                    job.cv.notify_all()
        if spec_release:
            self._release_spec(spec_release)
        return accepted

    @staticmethod
    def _peel(job: _Job) -> None:
        """Peeling pass (job.cv held): reduce every pending equation by
        known sources; a degree-1 equation recovers a source, which may
        unlock further peels."""
        progress = True
        while progress:
            progress = False
            keep = []
            for srcs, acc in job.equations:
                known = srcs & set(job.results)
                if known:
                    for s in known:
                        acc = np.bitwise_xor(acc, job.results[s])
                    srcs = srcs - known
                if not srcs:
                    continue          # fully redundant now
                if len(srcs) == 1:
                    s = next(iter(srcs))
                    if s not in job.results:
                        job.results[s] = acc
                        progress = True
                    continue
                keep.append((srcs, acc))
            job.equations = keep


# -- process-global dispatcher (the PLACEMENT pattern) --------------------

_LOCK = threading.Lock()
_DISPATCHER: RatelessDispatcher | None = None
_ENABLED = True


def get_dispatcher(conf=None, create: bool = True):
    """The process-global rateless dispatcher, created lazily from the
    osd_mesh_* options of a duck-typed `conf` (``get_val(key)``) on first
    use, over the visible CUDA devices. Returns None when disabled, when
    creation is declined, or below two CUDA devices (nothing to steal):
    on one card the path runs only through a dispatcher set with
    :func:`set_dispatcher` or passed explicitly."""
    global _DISPATCHER
    with _LOCK:
        if not _ENABLED:
            return None
        if _DISPATCHER is not None:
            return _DISPATCHER
        if not create:
            return None
        kw = {}
        if conf is not None:
            try:
                kw = {"factor":
                      conf.get_val("osd_mesh_microbatch_factor"),
                      "timeout_ms":
                      conf.get_val("osd_mesh_microbatch_timeout_ms"),
                      "blacklist_strikes":
                      conf.get_val("osd_mesh_blacklist_strikes"),
                      "probation_base_s":
                      conf.get_val("osd_mesh_probation_base_ms") / 1e3}
                if not conf.get_val("osd_mesh_rateless"):
                    return None
            except Exception:
                kw = {}
        if local_device_count() < 2:
            return None
        _DISPATCHER = RatelessDispatcher(**kw)
        return _DISPATCHER


def set_dispatcher(disp) -> None:
    global _DISPATCHER
    with _LOCK:
        _DISPATCHER = disp


def set_enabled(flag: bool) -> None:
    global _ENABLED
    with _LOCK:
        _ENABLED = bool(flag)


def reset_dispatcher() -> None:
    """Shut down and drop the process-global dispatcher."""
    global _DISPATCHER
    with _LOCK:
        disp, _DISPATCHER = _DISPATCHER, None
    if disp is not None:
        disp.shutdown()
