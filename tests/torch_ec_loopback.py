"""An in-process PG of n OSDs around one erasure-coded backend.

The reference's ECBackend runs under its PG (``ceph_tpu/osd/pg.py``) in an
OSD daemon, whose messenger carries its sub-ops. This harness stands in
for the three, the same kind of harness as ``tests/cluster_util.MiniCluster``
but reduced to one PG, and imports neither package: the caller passes the
package's classes in (``ECBackend``, ``MemStore``, ``Transaction``,
``PGLog``, ``entry_from_tuple``, ``SafeTimer`` and a tracer), so one
harness drives the reference's backend and the port's.

* Shard i of the PG lives on OSD i; OSD 0 is the primary. Each OSD has its
  own ``MemStore``, its own backend instance over its own listener, and a
  daemon with the attributes ECBackend reads: the dispatcher (under
  ``tpu_dispatcher`` or ``gpu_dispatcher``), ``hbm_tier``,
  ``hbm_serve_reads``, ``fused_mode``, ``fused_required_ratio``,
  ``fused_entropy_max``, ``timer``, ``tracer``, ``perf.inc`` and
  ``ctx.conf.get_val`` (``osd_ec_repair_enable``, on).
* The listener copies the PG methods the backend calls
  (``ceph_tpu/osd/pg.py:192-307``, ``osds_missing_object`` :1425-1432) and
  ``repair_shard`` (:2193), reduced to rebuilding the shard through
  ``backend.recover_object``, checking it against the hinfo crc and
  writing it back into the target's store (the force-push's role).
* Every OSD delivers its messages and its client ops in order on one
  thread of its own, as the reference's messenger and sharded op queue do
  for one PG: the backend's callbacks never run inside a sender's lock.
* An OSD can be marked down (its shard an acting hole,
  ``CRUSH_ITEM_NONE``, and its messages dropped); a shard store takes EIO
  or bitrot marks through its ``FaultSet`` (``store.faults``).

An exception raised on an OSD's thread is kept, and every wait re-raises
the first one.
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
import time
import zlib

CRUSH_ITEM_NONE = 0x7FFFFFFF
VERSION_ATTR = "_v"            # ceph_tpu/osd/pg.py:52
META_OID = "__pg_meta__"       # :53

_HANDLERS = {
    "MOSDECSubOpWrite": "handle_sub_write",
    "MOSDECSubOpWriteReply": "handle_sub_write_reply",
    "MOSDECSubOpRead": "handle_sub_read",
    "MOSDECSubOpReadReply": "handle_sub_read_reply",
    "MOSDECSubOpRepairRead": "handle_repair_read",
    "MOSDECSubOpRepairReadReply": "handle_repair_read_reply",
}


class _Perf:
    """The daemon's perf counters, as plain sums (``perf.inc``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counts: dict = {}

    def inc(self, name, n=1):
        with self.lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def get(self, name) -> int:
        with self.lock:
            return self.counts.get(name, 0)


class _Conf:
    def __init__(self, values):
        self.values = values

    def get_val(self, name):
        return self.values[name]


class _Ctx:
    def __init__(self, values):
        self.conf = _Conf(values)


class _Daemon:
    def __init__(self, whoami, timer, tracer, conf):
        self.whoami = whoami
        self.timer = timer
        self.tracer = tracer
        self.perf = _Perf()
        self.ctx = _Ctx(conf)
        self.hbm_tier = None
        self.hbm_serve_reads = False
        self.fused_mode = None
        self.fused_required_ratio = 0.875
        self.fused_entropy_max = 7.0


class _PG:
    """The listener ECBackend calls: ceph_tpu/osd/pg.py's PG methods."""

    def __init__(self, cluster, whoami, daemon, store, PGLog,
                 entry_from_tuple):
        self.cluster = cluster
        self.pgid = cluster.pgid
        self.whoami = whoami
        self.daemon = daemon
        self.store = store
        self.lock = threading.RLock()
        self.pg_log = PGLog()
        self._entry_from_tuple = entry_from_tuple
        self.last_version = 0
        self._repairing: set = set()
        self.backend = None

    # -- identity / listener interface (pg.py:192-307) -----------------

    def cid_of_shard(self, shard: int):
        return ("pg", str(self.pgid), shard)

    def my_shard(self) -> int:
        for i, osd in enumerate(self.cluster.acting):
            if osd == self.whoami:
                return i
        return -1

    def acting_shards(self) -> dict:
        return self.cluster.acting_shards()

    def map_epoch(self) -> int:
        return self.cluster.epoch

    def send_to_osd(self, osd: int, msg) -> None:
        self.cluster.deliver(osd, msg)

    def local_read_shard(self, shard: int, oid, off: int,
                         length: int) -> bytes:
        return self.store.read(self.cid_of_shard(shard), oid, off, length)

    def local_getattr(self, oid, name):
        try:
            return self.store.getattr(self.cid_of_shard(self.my_shard()),
                                      oid, name)
        except KeyError:
            return None

    def mint_log_entries(self, op_map, at_version: int,
                         reqid: tuple = ("", 0)) -> list:
        epoch = self.map_epoch()
        out = []
        for oid, obj_op in op_map.items():
            kind = "delete" if obj_op.is_delete() else "modify"
            raw = self.local_getattr(oid, VERSION_ATTR)
            try:
                prior = int(raw) if raw else 0
            except ValueError:
                prior = 0
            out.append((epoch, at_version, oid, kind, prior,
                        reqid[0], reqid[1]))
        return out

    def log_operation(self, log_entries, at_version, shard,
                      txn=None) -> None:
        """The entries into the in-memory log and, with the backend's
        store transaction, its durable omap keys in the same commit (the
        values in this harness's own text form)."""
        entries = [self._entry_from_tuple(t) for t in log_entries]
        dropped: list = []
        with self.lock:
            for entry in entries:
                dropped.extend(self.pg_log.append(entry))
            self.last_version = max(self.last_version, at_version)
        if txn is not None:
            cid = self.cid_of_shard(-1)
            txn.touch(cid, META_OID)
            kv = {"log:%016d.%016d" % (e.epoch, e.version): json.dumps(
                [e.epoch, e.version, e.oid, e.kind,
                 e.prior_version]).encode() for e in entries}
            if kv:
                txn.omap_setkeys(cid, META_OID, kv)
            if dropped:
                txn.omap_rmkeys(cid, META_OID, [
                    "log:%016d.%016d" % (e.epoch, e.version)
                    for e in dropped])

    def osds_missing_object(self, oid) -> set:
        """No shard is mid-recovery in this harness (pg.py:1425)."""
        return set()

    def repair_shard(self, oid, shard: int, peer_osd: int) -> None:
        """Read-path self-heal (pg.py:2193): rebuild the shard from the
        survivors, check it against the write-time hinfo crc, and write
        it back into the target's store, once per (oid, shard) at a
        time."""
        key = (oid, shard)
        with self.lock:
            if key in self._repairing:
                return
            self._repairing.add(key)

        def on_data(data):
            with self.lock:
                self._repairing.discard(key)
            if data is None:
                return
            h = self.backend.get_hinfo(oid)
            if h.has_chunk_hash() and \
                    (zlib.crc32(bytes(data)) & 0xFFFFFFFF) != \
                    h.get_chunk_hash(shard):
                return
            cid = self.cid_of_shard(shard)
            target = self.cluster.osds[peer_osd]

            def push():
                txn = self.cluster.Transaction()
                txn.write(cid, oid, 0, bytes(data))
                txn.truncate(cid, oid, len(data))
                target.store.queue_transaction(txn)
                self.cluster.repaired.append((oid, shard, peer_osd))

            self.cluster.call_on(peer_osd, push)
            self.daemon.perf.inc("repaired")

        self.backend.recover_object(oid, shard, on_data)


class _Osd:
    def __init__(self, cluster, whoami, daemon, store, pg, backend):
        self.whoami = whoami
        self.daemon = daemon
        self.store = store
        self.pg = pg
        self.backend = backend
        self.q: queue.Queue = queue.Queue()
        self.thread = threading.Thread(
            target=cluster._run, args=(self,), daemon=True,
            name="loopback-osd.%d" % whoami)


class _Op:
    """A client op in flight on the primary."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.event = threading.Event()
        self.value = None
        self.t0 = time.perf_counter()
        self.seconds = None

    def done(self, value=None) -> None:
        self.value = value
        self.seconds = time.perf_counter() - self.t0
        self.event.set()

    def result(self, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        while not self.event.wait(0.02):
            self.cluster.check()
            if time.monotonic() > deadline:
                raise TimeoutError("loopback op did not complete")
        self.cluster.check()
        return self.value


class Loopback:
    """One PG of ``codec.get_chunk_count()`` OSDs.

    ``dispatchers`` maps an OSD to its dispatcher (absent: none),
    ``dispatcher_attr`` names the daemon attribute ECBackend reads it
    from, ``tier`` is the primary's device chunk tier."""

    def __init__(self, *, ECBackend, MemStore, Transaction, PGLog,
                 entry_from_tuple, SafeTimer, tracer, codec,
                 stripe_width: int, dispatchers=None,
                 dispatcher_attr: str = "gpu_dispatcher", tier=None,
                 hbm_serve_reads: bool = False, fused_mode=None,
                 pgid: str = "1.0"):
        self.pgid = pgid
        self.Transaction = Transaction
        self.codec = codec
        self.n = codec.get_chunk_count()
        self.epoch = 1
        self.acting = list(range(self.n))
        self.down: set = set()
        self.repaired: list = []
        self.errors: list = []
        self.sent: dict = {}
        self.resent: dict = {}
        self._seen: set = set()
        self._sent_lock = threading.Lock()
        self._versions = itertools.count(1)
        self._reqids = itertools.count(1)
        self.timer = SafeTimer("loopback-timer")
        self.timer.init()
        conf = {"osd_ec_repair_enable": True}
        dispatchers = dispatchers or {}
        self.osds: list = []
        for whoami in range(self.n):
            daemon = _Daemon(whoami, self.timer, tracer, conf)
            setattr(daemon, dispatcher_attr, dispatchers.get(whoami))
            if whoami == 0:
                daemon.hbm_tier = tier
                daemon.hbm_serve_reads = hbm_serve_reads
                daemon.fused_mode = fused_mode
            store = MemStore()
            store.mount()
            txn = Transaction()
            txn.create_collection(("pg", str(pgid), -1))
            txn.create_collection(("pg", str(pgid), whoami))
            store.queue_transaction(txn)
            pg = _PG(self, whoami, daemon, store, PGLog, entry_from_tuple)
            backend = ECBackend(pg, codec, stripe_width)
            pg.backend = backend
            self.osds.append(_Osd(self, whoami, daemon, store, pg,
                                  backend))
        for osd in self.osds:
            osd.thread.start()

    @property
    def primary(self) -> _Osd:
        return self.osds[0]

    # -- the messenger -------------------------------------------------

    def acting_shards(self) -> dict:
        return {i: (CRUSH_ITEM_NONE if osd in self.down else osd)
                for i, osd in enumerate(self.acting)}

    def deliver(self, osd: int, msg) -> None:
        """Counts each message once in ``sent``: a retransmit (the
        primary's at-least-once re-fan-out of an unacked sub-write after
        1 s, which a slow first compile can provoke) is the same message
        object and goes to ``resent``."""
        name = type(msg).__name__
        with self._sent_lock:
            counts = self.resent if msg.seq in self._seen else self.sent
            self._seen.add(msg.seq)
            counts[name] = counts.get(name, 0) + 1
        if osd in self.down:
            return                # a dead peer's socket
        self.osds[osd].q.put(msg)

    def call_on(self, osd: int, fn) -> None:
        self.osds[osd].q.put(fn)

    def _run(self, osd: _Osd) -> None:
        while True:
            item = osd.q.get()
            if item is None:
                return
            try:
                if callable(item):
                    item()
                else:
                    getattr(osd.backend,
                            _HANDLERS[type(item).__name__])(item)
            except BaseException as e:   # kept, re-raised by waits
                self.errors.append(e)
            finally:
                osd.q.task_done()

    def check(self) -> None:
        if self.errors:
            raise self.errors[0]

    def drain(self, timeout: float = 120.0) -> None:
        """Wait until every OSD's queue has been empty and idle twice in
        a row (a handler may enqueue on another OSD)."""
        deadline = time.monotonic() + timeout
        quiet = 0
        while quiet < 2:
            self.check()
            if time.monotonic() > deadline:
                raise TimeoutError("loopback PG did not quiesce")
            if all(o.q.unfinished_tasks == 0 for o in self.osds):
                quiet += 1
            else:
                quiet = 0
            time.sleep(0.002)
        self.check()

    def shutdown(self) -> None:
        self.timer.shutdown()
        for osd in self.osds:
            osd.q.put(None)
        for osd in self.osds:
            osd.thread.join(timeout=10)

    # -- cluster state -------------------------------------------------

    def mark_down(self, *osds) -> None:
        self.down.update(osds)
        self.epoch += 1

    def mark_up(self, *osds) -> None:
        self.down.difference_update(osds)
        self.epoch += 1

    def cid(self, shard: int):
        return ("pg", str(self.pgid), shard)

    def shard_store(self, shard: int):
        return self.osds[self.acting[shard]].store

    # -- client ops, run on the primary's thread -----------------------

    def start(self, start) -> "_Op":
        """Run start(done) on the primary's thread; the op completes
        when done(x) is called there (or by a thread it hands off to)."""
        op = _Op(self)
        self.call_on(0, lambda: start(op.done))
        return op

    def submit_async(self, pg_txn, trace=None) -> "_Op":
        """A client write: the version xattr on every object it leaves
        (as the PG's do_op sets it), then submit_transaction under the
        client op's span ``trace``; the op's result is the version once
        every live shard has committed. Versions follow the order of the
        calls."""
        version = next(self._versions)
        for oid, op in pg_txn.op_map.items():
            if not op.is_delete():
                pg_txn.setattr(oid, VERSION_ATTR, str(version).encode())
        reqid = ("client.loopback", next(self._reqids))
        return self.start(
            lambda done: self.primary.backend.submit_transaction(
                pg_txn, version, lambda: done(version), reqid=reqid,
                trace=trace))

    def submit(self, pg_txn, timeout: float = 300.0) -> int:
        return self.submit_async(pg_txn).result(timeout)

    def read(self, oid, off: int = 0, length: int = 0,
             timeout: float = 300.0):
        """objects_read on the primary: the bytes, or None (EIO)."""
        return self.start(lambda done: self.primary.backend.objects_read(
            oid, off, length, done)).result(timeout)

    def recover(self, oid, shard: int, timeout: float = 300.0):
        """recover_object of one shard: its chunk stream, or None."""
        return self.start(lambda done: self.primary.backend.recover_object(
            oid, shard, done)).result(timeout)

    # -- what the stores hold ------------------------------------------

    def shard_objects(self, shard: int) -> dict:
        """{oid: (bytes, xattrs, omap)} of shard's collection."""
        store = self.shard_store(shard)
        cid = self.cid(shard)
        return {oid: (store.read(cid, oid), store.getattrs(cid, oid),
                      store.omap_get(cid, oid))
                for oid in store.list_objects(cid)}
