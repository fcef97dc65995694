"""In-process OSD daemons that host the real PGs of either package.

The reference's PG (``ceph_tpu/osd/pg.py``) runs inside an OSD daemon
(``ceph_tpu/osd/osd_daemon.py``) whose messenger, sharded op queue and
timer carry its work. This harness stands in for the daemon and the wire,
the same kind of harness as ``tests/torch_ec_loopback.py`` but with the
package's whole PG above ECBackend, and it imports neither package: the
caller passes a namespace ``pkg`` of the package's classes (``PG``,
``OSDMap``, ``Incremental``, ``PGPool``, ``PGID``, ``POOL_TYPE_ERASURE``,
``POOL_TYPE_REPLICATED``, ``build_crush`` (``tools/crushtool.build_map``),
``MemStore``, ``SafeTimer``, ``AsyncReserver``, ``MOSDOp``,
``MWatchNotifyAck`` and ``SpanCollector``), so one harness drives the
reference's PGs and the port's.

* ``n`` daemons, each with its own ``MemStore`` and the attributes a PG
  reads: ``whoami``, ``store``, ``osdmap``, ``timer``, ``perf``,
  ``ctx.conf``, ``op_wq``, ``tracer``, ``reservations`` (the daemon's
  five ``AsyncReserver`` lanes at the reference's default slots) with
  ``peering_gate`` on, ``home_device``, and what ECBackend reads (the
  port's dispatcher as ``gpu_dispatcher``, ``hbm_tier``,
  ``fused_mode``). ``ec_profile_for``
  copies ``osd_daemon.py:591-596``, ``scrub_pg`` :679-700,
  ``queue_recovery`` :771-774, the message routing :1585-1625 (by type
  name, to ``pg.handle_*`` and ``pg.backend.handle_*``), and a map's
  publication ``_on_osdmap`` :598-616 with ``_scan_for_new_pgs`` and
  ``_get_pg`` :651-677.
* Every daemon runs its messages and its ``op_wq`` items in order on one
  thread of its own, as the reference's sharded op queue runs one PG's
  items; timer callbacks run on the daemon's ``SafeTimer`` thread, as in
  the reference. A new map reaches every daemon's queue before any
  message sent in its epoch, the role of Ceph's
  ``require_same_or_newer_map``, which the reference's daemon lacks:
  without it a recovery pull that reaches a peer before the peer's map
  change is dropped by that change, and its object stays missing.
* A client op is an ``MOSDOp`` handed to the primary's ``pg.do_op`` on
  the primary's thread, with a reply function that records
  ``(result, data)``. ``send_to_client`` records watch notifies, and a
  watching client acks each.
* Faults: an OSD is marked down, up or out by a new map epoch. Marked
  down, a daemon is cut off: every message to or from it is dropped and
  it sees no map until it is marked up again. Marked down with
  ``crash``, it also dies (its queued items and timer events are
  dropped) and, marked up, restarts with its store and nothing else: its
  PGs are built anew and load their logs from the store. A shard store
  takes EIO or bitrot marks through its ``FaultSet`` (``store.faults``).

Every wait re-raises the first exception raised on a daemon's thread or
in a timer callback. ``drain()`` waits until every queue, timer callback
and PG is quiet (tests never sleep on a retry timer), and ``shutdown()``
joins every thread the harness started.
"""

from __future__ import annotations

import queue
import threading
import time

# the reference's option defaults (ceph_tpu/common/options.py)
CONF = {
    "osd_recovery_op_priority": 3,
    "osd_max_backfills": 1,
    "osd_recovery_max_active": 3,
    "osd_peering_max_active": 64,
    "osd_scrub_auto_repair": True,
    "osd_ec_repair_enable": True,
}

# osd_daemon.py:1585-1625: message type -> (on the backend?, handler)
_ROUTES = {
    "MOSDECSubOpWrite": (True, "handle_sub_write"),
    "MOSDECSubOpWriteReply": (True, "handle_sub_write_reply"),
    "MOSDECSubOpRead": (True, "handle_sub_read"),
    "MOSDECSubOpReadReply": (True, "handle_sub_read_reply"),
    "MOSDECSubOpRepairRead": (True, "handle_repair_read"),
    "MOSDECSubOpRepairReadReply": (True, "handle_repair_read_reply"),
    "MOSDRepOp": (True, "handle_rep_op"),
    "MOSDRepOpReply": (True, "handle_rep_op_reply"),
    "MOSDPGScan": (False, "handle_scan"),
    "MOSDPGPush": (False, "handle_push"),
    "MOSDPGPull": (False, "handle_pull"),
    "MOSDPGQuery": (False, "handle_query"),
    "MOSDPGNotify": (False, "handle_notify"),
    "MOSDPGLog": (False, "handle_log"),
    "MWatchNotifyAck": (False, "handle_notify_ack"),
    "MBackfillReserve": (False, "handle_reserve"),
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


class _OpQueue:
    """``op_wq``: every item of the daemon on its one FIFO thread."""

    def __init__(self, daemon):
        self.daemon = daemon

    def queue(self, pgid, fn, *args, **_qos):
        self.daemon.put(lambda: fn(*args))


class _Timer:
    """The daemon's SafeTimer. A callback's exception is kept for the
    waits, and a stopped daemon's events are dropped."""

    def __init__(self, cluster, daemon, SafeTimer):
        self.cluster = cluster
        self.daemon = daemon
        self.timer = SafeTimer("pg-loopback-timer.%d" % daemon.whoami)
        self.timer.init()

    def add_event_after(self, seconds, fn, *args):
        life = self.daemon.life
        return self.timer.add_event_after(seconds, self._fire, life, fn,
                                          args)

    def cancel_event(self, token):
        self.timer.cancel_event(token)

    def _fire(self, life, fn, args):
        if life != self.daemon.life:
            return                      # scheduled before a restart
        with self.cluster.busy_lock:
            self.cluster.timers_running += 1
        try:
            fn(*args)
        except BaseException as e:      # kept, re-raised by waits
            self.cluster.errors.append(e)
        finally:
            with self.cluster.busy_lock:
                self.cluster.timers_running -= 1


class _Daemon:
    def __init__(self, cluster, whoami, conf):
        pkg = cluster.pkg
        self.cluster = cluster
        self.pkg = pkg
        self.whoami = whoami
        self.life = 0                  # bumped by each crash
        self.up = True
        self.crashed = False
        self.lock = threading.RLock()
        self.pgs: dict = {}
        self.store = pkg.MemStore()
        self.store.mount()
        self.osdmap = None
        self.perf = _Perf()
        self.ctx = _Ctx(conf)
        self.tracer = pkg.SpanCollector()
        self.op_wq = _OpQueue(self)
        self.recovery_op_priority = conf["osd_recovery_op_priority"]
        self.home_device = cluster.home_device
        self.hbm_tier = None
        self.fused_mode = cluster.fused_mode
        self.q: queue.Queue = queue.Queue()
        self.reservations = self._reservers(conf)
        self.peering_gate = conf["osd_peering_max_active"] > 0
        self.timer = _Timer(cluster, self, pkg.SafeTimer)
        self.thread = threading.Thread(
            target=self._run, daemon=True,
            name="pg-loopback-osd.%d" % whoami)
        self.thread.start()

    def _reservers(self, conf):
        """osd_daemon.py:131-149."""
        R = self.pkg.AsyncReserver
        rec, bf = conf["osd_recovery_max_active"], conf["osd_max_backfills"]
        return {"local_recovery": R("local_recovery", rec),
                "remote_recovery": R("remote_recovery", rec),
                "local_backfill": R("local_backfill", bf),
                "remote_backfill": R("remote_backfill", bf),
                "peering": R("peering",
                             max(1, conf["osd_peering_max_active"]))}

    # -- the daemon's thread -------------------------------------------

    def put(self, fn) -> None:
        self.q.put((self.life, fn))

    def _run(self) -> None:
        while True:
            item = self.q.get()
            try:
                if item is None:
                    return
                life, fn = item
                if life == self.life:
                    fn()
            except BaseException as e:   # kept, re-raised by waits
                self.cluster.errors.append(e)
            finally:
                self.q.task_done()

    # -- what the PG calls ---------------------------------------------

    def map_epoch(self) -> int:
        return self.osdmap.epoch

    def ec_profile_for(self, pool) -> dict:
        """osd_daemon.py:591-596."""
        prof = self.osdmap.ec_profiles.get(pool.erasure_code_profile)
        if prof is None:
            raise KeyError("no EC profile %r" % pool.erasure_code_profile)
        return prof

    def queue_recovery(self, pg) -> None:
        """osd_daemon.py:771-774."""
        self.op_wq.queue(pg.pgid, pg.start_recovery, klass="recovery",
                         priority=self.recovery_op_priority)

    def send_to_osd_cluster(self, osd: int, msg) -> None:
        self.cluster.deliver(self.whoami, osd, msg)

    def send_to_client(self, addr, msg) -> None:
        self.cluster.to_client(self.whoami, addr, msg)

    def scrub_pg(self, pgid, deep: bool = False,
                 repair: bool = False) -> bool:
        """osd_daemon.py:679-700."""
        pg = self.pgs.get(pgid)
        if pg is None:
            return False
        with pg.lock:
            pg._scrub_seq = getattr(pg, "_scrub_seq", 0) + 1
            seq = pg._scrub_seq
            pg.scrub_stats = {"state": "queued"}
        self.op_wq.queue(pg.pgid, pg.scrub, seq, deep, repair,
                         klass="scrub",
                         priority=self.recovery_op_priority)
        return True

    # -- maps and PGs (osd_daemon.py:598-677) --------------------------

    def on_osdmap(self, newmap) -> None:
        with self.lock:
            self.osdmap = newmap
            pgs = list(self.pgs.values())
        for pg in pgs:
            self.op_wq.queue(pg.pgid, pg.on_map_change)
        self._scan_for_new_pgs()

    def _scan_for_new_pgs(self) -> None:
        m = self.osdmap
        for pool_id, pool in m.pools.items():
            for ps in range(pool.pg_num):
                pgid = self.pkg.PGID(pool_id, ps)
                with self.lock:
                    if pgid in self.pgs:
                        continue
                up, _, acting, _ = m.pg_to_up_acting_osds(pgid)
                if self.whoami in acting or self.whoami in up:
                    self._get_pg(pgid, pool)

    def _get_pg(self, pgid, pool=None):
        with self.lock:
            pg = self.pgs.get(pgid)
            if pg is None:
                if pool is None:
                    pool = self.osdmap.pools.get(pgid.pool)
                    if pool is None:
                        return None
                pg = self.pgs[pgid] = self.pkg.PG(self, pgid, pool)
                self.op_wq.queue(pgid, pg.on_map_change)
        return pg

    def normalize(self, raw_pgid):
        pool = self.osdmap.pools.get(raw_pgid.pool)
        return raw_pgid if pool is None else pool.raw_pg_to_pg(raw_pgid)

    def enqueue_message(self, msg) -> None:
        """osd_daemon.py:1576-1625: the PG is found (or made) on the
        sender's thread, the handler runs on this daemon's thread."""
        pg = self._get_pg(self.normalize(msg.pgid))
        if pg is None:
            return
        on_backend, name = _ROUTES[type(msg).__name__]
        self.op_wq.queue(
            pg.pgid, lambda: getattr(pg.backend if on_backend else pg,
                                     name)(msg))

    def stop(self, crash: bool) -> None:
        """Marked down: cut off from the wire, and with ``crash`` dead
        with its queue and its timer events."""
        with self.lock:
            self.up = False
            self.crashed = crash
            if crash:
                self.life += 1
        if crash:
            self.timer.timer.cancel_all_events()

    def start(self, newmap) -> None:
        """Marked up: back on the wire with the new map. After a crash
        its store survives and nothing else: its PGs are built anew."""
        with self.lock:
            self.up = True
            if self.crashed:
                self.pgs = {}
                if self.hbm_tier is not None:
                    self.hbm_tier = self.cluster.make_tier(self.whoami)
            self.crashed = False
        self.on_osdmap(newmap)


class _Op:
    """A client op in flight: ``result()`` waits for its reply."""

    def __init__(self, cluster, label):
        self.cluster = cluster
        self.label = label
        self.event = threading.Event()
        self.reply = None
        self.t0 = time.perf_counter()
        self.seconds = None

    def done(self, result, data) -> None:
        if self.event.is_set():
            return
        self.reply = (result, data)
        self.seconds = time.perf_counter() - self.t0
        self.event.set()

    def result(self, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        while not self.event.wait(0.005):
            self.cluster.check()
            if time.monotonic() > deadline:
                raise TimeoutError("op %s did not complete" % (self.label,))
        self.cluster.check()
        return self.reply


class Cluster:
    """``n`` daemons sharing one map: one host a daemon under one root,
    with a replicated rule (0, chooseleaf firstn over hosts) and an
    erasure rule (1, chooseleaf indep over hosts).

    ``make_dispatcher(osd)`` and ``make_tier(osd)`` give a daemon the
    port's dispatcher and its device chunk tier; ``home_device`` and
    ``fused_mode`` are every daemon's."""

    def __init__(self, pkg, n: int, *, home_device=None,
                 make_dispatcher=None, make_tier=None, fused_mode=None):
        self.pkg = pkg
        self.n = n
        self.home_device = home_device
        self.fused_mode = fused_mode
        self.make_tier = make_tier
        self.errors: list = []
        self.busy_lock = threading.Lock()
        # a publication reaches every daemon's queue before any message
        # sent in its epoch
        self.map_lock = threading.RLock()
        self.timers_running = 0
        self.sent: dict = {}
        self.notifies: list = []         # (osd, client addr, message)
        self.clients: dict = {}          # addr -> ack payload or None
        self._threads_before = set(threading.enumerate())
        self._tid = 0
        self._acting: dict = {}
        self.daemons: list = []
        try:
            for whoami in range(n):
                d = _Daemon(self, whoami, CONF)
                if make_dispatcher is not None:
                    d.gpu_dispatcher = make_dispatcher(whoami)
                if make_tier is not None:
                    d.hbm_tier = make_tier(whoami)
                self.daemons.append(d)
            crush = pkg.build_crush(n, [("host", "straw2", 1),
                                        ("root", "straw2", 0)])
            crush.add_simple_rule("replicated_rule", "default",
                                  failure_domain="host", mode="firstn")
            crush.add_simple_rule("erasure_rule", "default",
                                  failure_domain="host", mode="indep",
                                  rule_type=pkg.POOL_TYPE_ERASURE)
            self.osdmap = pkg.OSDMap()

            def boot(inc):
                inc.new_max_osd = n
                inc.new_crush = crush
                for osd in range(n):
                    inc.new_up[osd] = ("127.0.0.1", 6800 + osd)
                    inc.new_weight[osd] = 0x10000

            self.publish(boot)
        except BaseException:
            self.shutdown()
            raise

    # -- the map -------------------------------------------------------

    def publish(self, fill, crash: bool = False) -> float:
        """A new epoch: ``fill(inc)`` fills the package's Incremental,
        which is applied to a copy of the map; every live daemon gets the
        new map (``_on_osdmap``), a daemon marked up starts with it, and
        one marked down stops (with ``crash``, dies). Returns the
        publication's perf_counter stamp."""
        inc = self.pkg.Incremental(self.osdmap.epoch + 1)
        fill(inc)
        m = self.osdmap.clone()
        m.apply_incremental(inc)
        t0 = time.perf_counter()
        with self.map_lock:
            self.osdmap = m
            for d in self.daemons:
                if m.is_up(d.whoami):
                    if d.up:
                        d.on_osdmap(m)
                    else:
                        d.start(m)
                elif d.up:
                    d.stop(crash)
        return t0

    def create_pool(self, pool_id: int, name: str, *, size: int,
                    min_size: int, pg_num: int, profile=None,
                    stripe_width: int = 0) -> None:
        """An erasure pool when ``profile`` (with its "plugin") is
        given, else a replicated one."""
        pkg = self.pkg

        def fill(inc):
            if profile is not None:
                inc.new_ec_profiles[name] = dict(profile)
            inc.new_pools[pool_id] = pkg.PGPool(
                pool_id=pool_id, name=name,
                type=(pkg.POOL_TYPE_ERASURE if profile is not None
                      else pkg.POOL_TYPE_REPLICATED),
                size=size, min_size=min_size, pg_num=pg_num,
                crush_rule=1 if profile is not None else 0,
                erasure_code_profile=name if profile is not None else "",
                stripe_width=stripe_width)

        self.publish(fill)

    def set_pool(self, pool_id: int, **fields) -> None:
        """A new epoch whose pool carries ``fields`` (removed_snaps...)."""
        def fill(inc):
            pool = self.osdmap.clone().pools[pool_id]
            for k, v in fields.items():
                setattr(pool, k, v)
            inc.new_pools[pool_id] = pool

        self.publish(fill)

    def mark_down(self, *osds, crash: bool = False) -> float:
        """Without ``crash`` a partition: the daemons keep their state
        and their work, cut off from the wire until marked up."""
        return self.publish(lambda inc: inc.new_down.extend(osds),
                            crash=crash)

    def mark_up(self, *osds) -> float:
        def fill(inc):
            for osd in osds:
                inc.new_up[osd] = ("127.0.0.1", 6800 + osd)
        return self.publish(fill)

    def mark_out(self, *osds) -> float:
        def fill(inc):
            for osd in osds:
                inc.new_weight[osd] = 0
        return self.publish(fill)

    def pgid_of(self, pool_id: int, oid):
        return self.osdmap.pools[pool_id].raw_pg_to_pg(
            self.osdmap.object_to_pg(pool_id, oid))

    def acting(self, pgid) -> tuple:
        """(acting, primary) of the pgid under the current map."""
        m = self.osdmap
        key = (m.epoch, pgid)
        got = self._acting.get(key)
        if got is None:
            _, _, acting, primary = m.pg_to_up_acting_osds(pgid)
            got = self._acting[key] = (tuple(acting), primary)
        return list(got[0]), got[1]

    def pgids(self, pool_id: int) -> list:
        pool = self.osdmap.pools[pool_id]
        return [self.pkg.PGID(pool_id, ps) for ps in range(pool.pg_num)]

    def primary_pg(self, pgid):
        """The PG object on the pgid's acting primary."""
        _, primary = self.acting(pgid)
        return self.daemons[primary].pgs.get(pgid)

    # -- the wire ------------------------------------------------------

    def deliver(self, src: int, dst: int, msg) -> None:
        """Queued on the receiver behind every map published before it
        was sent (the reference OSD's require_same_or_newer_map role)."""
        name = type(msg).__name__
        with self.busy_lock:
            self.sent[name] = self.sent.get(name, 0) + 1
        with self.map_lock:
            if not (self.daemons[src].up and self.daemons[dst].up):
                return                   # a dead daemon's socket
            msg.from_name = ("osd", src)
            self.daemons[dst].enqueue_message(msg)

    def to_client(self, osd: int, addr, msg) -> None:
        """A watch notify: recorded, and acked by a watching client."""
        self.notifies.append((osd, addr, msg))
        reply = self.clients.get(tuple(addr))
        if reply is None:
            return
        ack = self.pkg.MWatchNotifyAck(
            pgid=msg.pgid, oid=msg.oid, cookie=msg.cookie,
            notify_id=msg.notify_id, reply=reply)
        ack.from_name = ("client", addr[1])
        with self.map_lock:
            if self.daemons[osd].up:
                self.daemons[osd].enqueue_message(ack)

    def watcher(self, client: int, reply: bytes) -> None:
        """Client ``client`` acks every notify it gets with ``reply``."""
        self.clients[("client", client)] = reply

    # -- clients -------------------------------------------------------

    def next_tid(self) -> int:
        with self.busy_lock:
            self._tid += 1
            return self._tid

    def submit(self, pool_id: int, oid, ops, *, snapc=(0, ()), snap=0,
               client: int = 1, flags: int = 0, tid=None) -> _Op:
        """One MOSDOp to the object's primary, run on its thread through
        ``pg.do_op``; the returned op's ``result()`` is its reply."""
        raw = self.osdmap.object_to_pg(pool_id, oid)
        msg = self.pkg.MOSDOp(
            client_id=client, tid=tid or self.next_tid(), pgid=raw, oid=oid,
            ops=list(ops), map_epoch=self.osdmap.epoch, snapc=snapc,
            snap=snap, session="client.%d" % client, flags=flags)
        msg.from_name = ("client", client)
        msg.from_addr = ("client", client)
        op = _Op(self, (oid, ops[0][0] if ops else ""))
        pgid = self.osdmap.pools[pool_id].raw_pg_to_pg(raw)
        _, primary = self.acting(pgid)
        d = self.daemons[primary]

        def run():
            pg = d._get_pg(pgid)
            if pg is None:
                op.done(-11, None)
                return
            try:
                pg.do_op(msg, op.done)
            except BaseException:
                op.done(-5, None)        # the daemon fails it with EIO
                raise

        d.op_wq.queue(pgid, run)
        return op

    def call(self, pool_id: int, oid, ops, **kw):
        return self.submit(pool_id, oid, ops, **kw).result()

    def run_lanes(self, ops: list) -> list:
        """``ops``: [(pool_id, oid, op vector, kw)]. The ops of one PG
        run one after another in list order, the PGs' lanes side by side;
        returns every reply in list order. Tids follow the list."""
        lanes: dict = {}
        for i, (pool_id, oid, vec, kw) in enumerate(ops):
            lanes.setdefault(self.pgid_of(pool_id, oid), []).append(
                (i, pool_id, oid, vec, dict(kw, tid=self.next_tid())))
        out = [None] * len(ops)
        heads = {}                       # lane -> (index, op in flight)
        todo = {key: list(lane) for key, lane in lanes.items()}
        while todo or heads:
            for key in list(todo):
                if key not in heads:
                    i, pool_id, oid, vec, kw = todo[key].pop(0)
                    if not todo[key]:
                        del todo[key]
                    heads[key] = (i, self.submit(pool_id, oid, vec, **kw))
            waiting = True
            for key, (i, op) in list(heads.items()):
                if op.event.is_set():
                    out[i] = op.result()
                    del heads[key]
                    waiting = False
            self.check()
            if waiting and heads:
                next(iter(heads.values()))[1].event.wait(0.005)
        return out

    # -- waits ---------------------------------------------------------

    def check(self) -> None:
        if self.errors:
            raise self.errors[0]

    def pg_busy(self, pg) -> str | None:
        """Why a live PG is not quiet, or None."""
        with pg.lock:
            if pg.missing:
                return "missing %d" % len(pg.missing)
            if pg.acting_primary != pg.whoami:
                return None
            if pg.peer_state != "active":
                return "peering (%s)" % pg.peer_state
            if pg.peer_missing or pg.backfilling:
                return "recovering"
            if any(pg._resv_pending.values()):
                return "waiting for reservations"
            if pg.waiting_for_active or pg._obj_gate:
                return "ops in flight"
            if pg._scrub_waiting or pg.scrub_stats.get("state") in (
                    "queued", "scrubbing"):
                return "scrubbing"
        return None

    def busy(self) -> list:
        out = []
        for d in self.daemons:
            if d.q.unfinished_tasks:
                out.append("osd.%d queue" % d.whoami)
            if not d.up:
                continue
            for pgid, pg in list(d.pgs.items()):
                why = self.pg_busy(pg)
                if why:
                    out.append("osd.%d pg %s: %s" % (d.whoami, pgid, why))
        if self.timers_running:
            out.append("timer callbacks")
        if self._new_threads("deep-scrub"):
            out.append("deep-scrub threads")
        return out

    def _new_threads(self, name: str) -> list:
        return [t for t in threading.enumerate()
                if t.name == name and t not in self._threads_before
                and t.is_alive()]

    def drain(self, timeout: float = 120.0) -> None:
        """Wait until the whole cluster is quiet twice in a row."""
        deadline = time.monotonic() + timeout
        quiet = 0
        while quiet < 2:
            self.check()
            busy = self.busy()
            if time.monotonic() > deadline:
                raise TimeoutError("loopback cluster did not quiesce: %s"
                                   % "; ".join(busy[:8]))
            quiet = 0 if busy else quiet + 1
            time.sleep(0.002)
        self.check()

    def wait_active(self, pool_id: int, t0: float,
                    timeout: float = 120.0) -> float:
        """Wait until every PG of the pool is active on its acting
        primary under the current map; returns the ms since ``t0`` (a
        publication's stamp)."""
        deadline = time.monotonic() + timeout
        while True:
            self.check()
            pending = 0
            for pgid in self.pgids(pool_id):
                acting, primary = self.acting(pgid)
                pg = self.daemons[primary].pgs.get(pgid)
                if pg is None:
                    pending += 1
                    continue
                with pg.lock:
                    if pg.peer_state != "active" or pg.acting != acting:
                        pending += 1
            if not pending:
                return (time.perf_counter() - t0) * 1e3
            if time.monotonic() > deadline:
                raise TimeoutError("%d PGs of pool %d not active"
                                   % (pending, pool_id))
            time.sleep(0.0005)

    def scrub(self, pool_id: int, deep: bool = True,
              repair: bool = False) -> dict:
        """``scrub_pg`` of every PG of the pool on its primary, then a
        drain; returns {pgid: scrub_stats}."""
        for pgid in self.pgids(pool_id):
            _, primary = self.acting(pgid)
            assert self.daemons[primary].scrub_pg(pgid, deep=deep,
                                                  repair=repair)
        self.drain()
        return {pgid: dict(self.primary_pg(pgid).scrub_stats)
                for pgid in self.pgids(pool_id)}

    def shutdown(self) -> None:
        """Stop every daemon and join every thread the harness started
        (the daemons', their timers' and the PGs' deep-scrub threads)."""
        for d in self.daemons:
            d.timer.timer.shutdown()
            d.q.put(None)
        for d in self.daemons:
            d.thread.join(timeout=10)
        for t in self._new_threads("deep-scrub"):
            t.join(timeout=10)

    def threads_alive(self) -> list:
        return [t.name for t in threading.enumerate()
                if t not in self._threads_before and t.is_alive()
                and (t.name.startswith("pg-loopback")
                     or t.name == "deep-scrub")]

    def perf_totals(self) -> dict:
        """Every daemon's perf counters, summed by name."""
        out: dict = {}
        for d in self.daemons:
            with d.perf.lock:
                for name, n in d.perf.counts.items():
                    out[name] = out.get(name, 0) + n
        return out

    # -- what the stores hold ------------------------------------------

    def collections(self, osd: int) -> dict:
        """{cid: {oid: (bytes, xattrs, omap)}} of an OSD's store."""
        store = self.daemons[osd].store
        out = {}
        for cid in sorted(store.list_collections(), key=repr):
            out[cid] = {oid: (store.read(cid, oid), store.getattrs(cid, oid),
                              store.omap_get(cid, oid))
                        for oid in sorted(store.list_objects(cid), key=repr)}
        return out
