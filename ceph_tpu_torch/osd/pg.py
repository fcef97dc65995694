"""Placement group: op execution, logging, peering, recovery drive.

Role of the reference's PG/PrimaryLogPG (src/osd/PG.{h,cc},
PrimaryLogPG.cc): a PG executes client ops in order through its backend
(do_op -> execute_ctx -> submit_transaction), maintains a durable
per-PG op log (osd/pg_log.py; entries stamped with (epoch,
version) eversions), and converges replicas through the peering rounds
of the reference statechart (PG.h:1811):

  GetInfo      on an interval change the primary queries every up/
               acting peer for its pg info (MOSDPGQuery what=info);
  GetLog       the peer with the highest last_update is authoritative;
               if that is not us, we pull its log delta and MERGE —
               divergent entries (dead-interval writes) are undone,
               newer authoritative entries become `missing`
               (PGLog.merge; ecbackend.rst:149-174 roll-forward);
  GetMissing   activation sends every replica the log segment it
               lacks; replicas merge, report their missing sets, and
               the primary pushes exactly those objects — no inventory
               scan when logs overlap. Scan-based backfill remains the
               fallback for peers whose logs do not overlap (the
               reference's backfill lane).

Writes are gated on activation (active_for_write), so a new primary
cannot mint entries on a stale chain that a later merge would rewind.

Collections: one per (pg, shard) — EC shard s lives in cid
("pg", str(pgid), s) on its host OSD; replicated uses shard -1
(mirroring ghobject shard_id_t namespacing).

Port of ``ceph_tpu/osd/pg.py``. The op paths, peering rounds, recovery,
backfill, reservations, scrub and repair are the reference's, and so are
the bytes a PG persists (the log rows and snapsets through the port's
``encoding``). Where the port differs:

* The codec is built on the daemon's ``home_device`` (:170-173 passes
  none): ``None`` is the card, and the port's device plugins raise
  without CUDA unless the daemon names ``"cpu"``. Its encodes and
  decodes then reach the card's kernels through ECBackend and the
  daemon's ``gpu_dispatcher``.
* ``_digest_from_tier`` treats only a miss as "not resident": the tier's
  ``shard_digests`` returning None, its ``KeyError``, or a shard row
  past the digest row's end. Any other error (a fault of the tier or of
  the card) propagates, where the reference's ``except Exception``
  (:1887) would quietly send deep scrub to host hashing.
* An op parked on a missing object (``do_op``, :538-542) that fails when
  its push wakes it replies EIO, and the push (``handle_push``) runs
  every parked op and then raises the first such error, where the
  reference drops it (:2778-2782) and the failed op never replies.
* The cache tier's ``PGTier`` (``_tier``, :464-474) waits for the RADOS
  client's slice: an op on a cache-tier pool raises
  ``NotImplementedError`` naming it, instead of being served.
"""

from __future__ import annotations

import logging
import threading
import time as _time

from .. import encoding
from ..common.lockdep import make_rlock
from ..msg.message import (MBackfillReserve, MOSDPGLog, MOSDPGNotify,
                           MOSDPGPull, MOSDPGPush, MOSDPGQuery,
                           MOSDPGScan, MWatchNotify)
from ..store.object_store import Transaction
from .ec_backend import ECBackend
from .osd_map import CRUSH_ITEM_NONE, POOL_TYPE_ERASURE
from .pg_log import PGLog, entry_from_tuple
from .pg_transaction import PGTransaction
from .replicated_backend import ReplicatedBackend

__all__ = ["PG"]

VERSION_ATTR = "_v"
META_OID = "__pg_meta__"
SNAPSET_ATTR = "_ss"
WHITEOUT_ATTR = "_whiteout"

# reservation priorities (the reference's OSD_RECOVERY_PRIORITY
# ladder, collapsed to two rungs): degraded-object recovery preempts
# routine backfill in the AsyncReservers, never the other way around
_RESV_PRIO = {"recovery": 180, "backfill": 90, "peering": 250}


def host_crc32(data) -> int:
    """Host-side shard hashing for scrub inventories — the fallback
    when an object is not resident in the device chunk tier with
    device digests.  Module-
    level (not inlined) so tests can assert the fused scrub-from-digest
    path never hashes a byte on the host."""
    import zlib
    return zlib.crc32(data) & 0xFFFFFFFF


def clone_name(oid, cloneid: int) -> str:
    """Clone objects live beside the head as '<oid>@<cloneid>'
    (the ghobject snap id at framework scale)."""
    return "%s@%d" % (oid, cloneid)


def is_clone_oid(oid) -> bool:
    return isinstance(oid, str) and "@" in oid


def is_user_xattr(name: str) -> bool:
    """Is this xattr CLIENT-visible? Internal bookkeeping attrs are
    underscore-prefixed, and the EC hinfo is filtered by name exactly
    like the reference (PrimaryLogPG GETXATTRS strips
    ECUtil::get_hinfo_key()). One definition — getxattrs, copy_get,
    resetxattrs, and the tier flush all share it."""
    return not name.startswith("_") and name != "hinfo_key"


def user_xattrs(attrs: dict) -> dict:
    return {k: v for k, v in attrs.items() if is_user_xattr(k)}


class PG:
    def __init__(self, daemon, pgid, pool):
        self.daemon = daemon
        self.pgid = pgid
        self.pool = pool
        self.whoami = daemon.whoami
        self.store = daemon.store
        self.lock = make_rlock("pg:%s" % (pgid,))
        self.acting: list[int] = []
        self.acting_primary = -1
        self.up: list[int] = []
        self.interval = 0
        self.last_version = 0
        self.pg_log = PGLog()
        self.waiting_for_active: list = []
        self._pulling: dict = {}   # oid -> pull sent at (monotonic)
        self._deleted_log: dict = {}   # oid -> version it was deleted at
        self.scrub_stats: dict = {"state": "never"}
        # unrepaired errors from the LAST completed scrub: reported to
        # the mon in pg stats (MPGStats) and the input behind the
        # OSD_SCRUB_ERRORS health check; cleared by a repairing scrub
        self.scrub_errors = 0
        self._scrub_waiting: set = set()
        self._scrub_replies: dict = {}
        self._repairing: set = set()   # (oid, shard) read-repairs live
        # peering (GetInfo/GetLog/GetMissing)
        self.peer_state = "idle"      # idle|peering|active|replica
        self._peer_seq = 0
        self._peer_infos: dict = {}   # osd -> info dict
        self._peer_wait: set = set()
        self.missing: dict = {}       # oid -> version we need
        self._missing_src: dict = {}  # oid -> osd holding it
        self._missing_waiters: dict = {}   # oid -> [continuations]
        # primary-side map of PEERS' missing objects (the reference's
        # peer_missing / MissingLoc): a shard OSD that reported an
        # object missing serves STALE bytes until its recovery push is
        # acked — EC reads must reconstruct around it, not from it
        self.peer_missing: dict = {}  # oid -> set(osd)
        # backfill lane bookkeeping (pg_stat_t misplaced role): shards
        # being copied to a NEW acting member after a remap — data is
        # still fully readable elsewhere, so these count as misplaced,
        # not degraded, and deliberately do NOT feed the EC
        # read-routing that peer_missing drives
        self.backfilling: dict = {}   # oid -> set(osd)
        self._push_retrying: set = set()   # (oid, peer) retry chains
        # recovery/backfill reservation state machine (the reference's
        # PG recovery-reservation states, common/reserver.py slots):
        # per lane, idle -> local_wait -> remote_wait -> granted, with
        # "toofull" parking a fullness-rejected round.  Pushes queue in
        # _resv_pending while ungranted and drain onto the recovery op
        # class once the local slot AND every replica's remote slot are
        # held.  _resv_remote_keys is the REPLICA side: primaries whose
        # requests we hold/queue remote slots for (cancelled on
        # interval change so a dead primary cannot leak our slots).
        self._resv_state = {"recovery": "idle", "backfill": "idle"}
        self._resv_pending = {"recovery": [], "backfill": []}
        self._resv_want = {"recovery": set(), "backfill": set()}
        self._resv_have = {"recovery": set(), "backfill": set()}
        self._resv_remote_keys: set = set()   # (lane, primary_osd)
        # reqid -> version, rebuilt from the log: the failover-safe
        # client-retransmit dedup (pg_log_entry_t::reqid role)
        from ..common.bounded import BoundedDict
        self._reqids: BoundedDict = BoundedDict()
        self._trimmed_snaps: set = set()
        # EC mutation serialization per object (ObjectContext rw-lock
        # role): the async snapshot pre-read window must not interleave
        # with another write to the same object
        self._obj_gate: dict = {}
        # watch/notify (PrimaryLogPG watchers; volatile on the primary,
        # clients re-watch after a primary change like the Objecter's
        # linger resend)
        self.watchers: dict = {}      # oid -> {cookie: client addr}
        self._notifies: dict = {}     # notify_id -> state
        self._notify_seq = 0
        self._tier_state = None       # PGTier, created on first use
        if pool.is_erasure():
            from .. import registry
            profile = daemon.ec_profile_for(pool)
            codec = registry.factory(
                profile["plugin"], dict(profile),
                device=getattr(daemon, "home_device", None))
            self.backend = ECBackend(self, codec, pool.stripe_width)
        else:
            self.backend = ReplicatedBackend(self)
        self._ensure_collections()
        self._load_log()
        # a (re)started OSD must never mint versions below what its own
        # store has seen, or recovery judges stale peer copies "newer"
        # and clobbers acked writes
        for shard in ([-1] if not pool.is_erasure()
                      else list(range(pool.size)) + [-1]):
            for v in self._local_inventory(shard).values():
                if v > self.last_version:
                    self.last_version = v
        self.last_version = max(self.last_version,
                                self.pg_log.head[1])

    # -- identity / listener interface for backends --------------------

    def cid_of_shard(self, shard: int):
        return ("pg", str(self.pgid), shard)

    def my_shard(self) -> int:
        """This OSD's shard in the acting set (-1 for replicated)."""
        if not self.pool.is_erasure():
            return -1
        with self.lock:
            for i, osd in enumerate(self.acting):
                if osd == self.whoami:
                    return i
        return -1

    def acting_osds(self) -> list:
        with self.lock:
            return list(self.acting)

    def acting_shards(self) -> dict:
        """shard -> osd (CRUSH_ITEM_NONE holes preserved for EC)."""
        with self.lock:
            return {i: osd for i, osd in enumerate(self.acting)}

    def is_primary(self) -> bool:
        with self.lock:
            return self.acting_primary == self.whoami

    def map_epoch(self) -> int:
        return self.daemon.map_epoch()

    def send_to_osd(self, osd: int, msg) -> None:
        self.daemon.send_to_osd_cluster(osd, msg)

    def local_read_shard(self, shard: int, oid, off: int,
                         length: int) -> bytes:
        if shard != -1 and self.pool.is_erasure():
            # replicas serve THEIR shard; the cid names it explicitly
            return self.store.read(self.cid_of_shard(shard), oid, off,
                                   length)
        return self.store.read(self.cid_of_shard(-1), oid, off, length)

    def local_getattr(self, oid, name):
        shard = self.my_shard()
        try:
            return self.store.getattr(self.cid_of_shard(shard), oid, name)
        except KeyError:
            return None

    PG_LOG_CAP = 5000

    def mint_log_entries(self, op_map, at_version: int,
                         reqid: tuple = ("", 0)) -> list:
        """Wire-form entries for a write being submitted: (epoch,
        version, oid, kind, prior, session, tid). The epoch half of
        the eversion lets a later merge tell two same-numbered forks
        apart; the reqid rides REPLICATED so any future primary can
        dedup a client retransmit (exactly-once across failover)."""
        epoch = self.map_epoch()
        out = []
        for oid, obj_op in op_map.items():
            kind = "delete" if obj_op.is_delete() else "modify"
            prior = self._object_version(oid)
            out.append((epoch, at_version, oid, kind, prior,
                        reqid[0], reqid[1]))
        return out

    def _object_version(self, oid) -> int:
        raw = self.local_getattr(oid, VERSION_ATTR)
        try:
            return int(raw) if raw else 0
        except ValueError:
            return 0

    def log_operation(self, log_entries, at_version, shard,
                      txn=None) -> None:
        """Record entries in the in-memory log and make them durable.
        With `txn` (the backend's store transaction for this write)
        the log omap keys ride THE SAME transaction as the data — one
        commit, atomic, like the reference writing pg log keys in the
        op's ObjectStore::Transaction."""
        entries = [entry_from_tuple(t) for t in log_entries]
        dropped: list = []
        with self.lock:
            for entry in entries:
                dropped.extend(self.pg_log.append(entry))
                self.missing.pop(entry.oid, None)
                if entry.reqid[0]:
                    self._reqids[tuple(entry.reqid)] = entry.version
                v, oid, kind = entry.version, entry.oid, entry.kind
                if kind == "delete":
                    # divergence oracle for the scan/backfill lane:
                    # "oid was deleted at version v" (LRU re-insert)
                    if v > self._deleted_log.get(oid, -1):
                        self._deleted_log.pop(oid, None)
                        self._deleted_log[oid] = v
                elif v > self._deleted_log.get(oid, -1):
                    self._deleted_log.pop(oid, None)
            while len(self._deleted_log) > self.PG_LOG_CAP:
                self._deleted_log.pop(next(iter(self._deleted_log)))
            self.last_version = max(self.last_version, at_version)
        if txn is not None:
            cid = self._meta_cid()
            txn.touch(cid, META_OID)
            kv = {self._log_key(e): encoding.encode_any(
                (e.epoch, e.version, e.oid, e.kind, e.prior_version))
                for e in entries}
            if kv:
                txn.omap_setkeys(cid, META_OID, kv)
            if dropped:
                # the durable omap trims with the in-memory log, or it
                # (and the log reloaded at restart) grows forever
                txn.omap_rmkeys(cid, META_OID,
                                [self._log_key(e) for e in dropped])
        else:
            self._persist_log_delta(entries, dropped)

    # -- durable log (meta object omap, the reference's pg log omap) ---

    def _meta_cid(self):
        return self.cid_of_shard(-1)

    @staticmethod
    def _log_key(entry) -> str:
        return "log:%016d.%016d" % (entry.epoch, entry.version)

    def _persist_log_delta(self, entries, dropped=()) -> None:
        txn = Transaction()
        cid = self._meta_cid()
        txn.touch(cid, META_OID)
        kv = {self._log_key(e): encoding.encode_any(
            (e.epoch, e.version, e.oid, e.kind, e.prior_version))
            for e in entries}
        if kv:
            txn.omap_setkeys(cid, META_OID, kv)
        if dropped:
            txn.omap_rmkeys(cid, META_OID,
                            [self._log_key(e) for e in dropped])
        self.store.queue_transaction(txn)

    def _persist_log_full(self) -> None:
        """Rewrite the whole durable log (after a merge rewound it)."""
        txn = Transaction()
        cid = self._meta_cid()
        txn.remove(cid, META_OID)
        txn.touch(cid, META_OID)
        with self.lock:
            rows = self.pg_log.dump()
        kv = {"log:%016d.%016d" % (r[0], r[1]): encoding.encode_any(r)
              for r in rows}
        if kv:
            txn.omap_setkeys(cid, META_OID, kv)
        self.store.queue_transaction(txn)

    def _rebuild_reqids(self) -> None:
        with self.lock:
            self._reqids.clear()
            for e in self.pg_log.entries:
                if e.reqid[0]:
                    self._reqids[tuple(e.reqid)] = e.version

    def _load_log(self) -> None:
        try:
            omap = self.store.omap_get(self._meta_cid(), META_OID)
        except KeyError:
            return
        rows = []
        for key, raw in omap.items():
            if isinstance(key, str) and key.startswith("log:"):
                try:
                    rows.append(encoding.decode_any(raw))
                except encoding.DecodeError:
                    continue
        if rows:
            rows.sort(key=lambda r: (r[0], r[1]))
            self.pg_log.load(rows)
            self._rebuild_reqids()

    def _ensure_collections(self) -> None:
        txn = Transaction()
        if self.pool.is_erasure():
            for shard in range(self.pool.size):
                txn.create_collection(self.cid_of_shard(shard))
        txn.create_collection(self.cid_of_shard(-1))
        self.store.queue_transaction(txn)

    # -- peering-lite --------------------------------------------------

    def on_map_change(self) -> None:
        m = self.daemon.osdmap
        newpool = m.pools.get(self.pgid.pool)
        if newpool is not None and newpool is not self.pool:
            # pool metadata (removed_snaps) rides the
            # map; trim clones for newly removed snaps
            fresh = [s for s in newpool.removed_snaps
                     if s not in self._trimmed_snaps]
            self.pool = newpool
            if fresh:
                self._trimmed_snaps.update(fresh)
                # trim runs as its own snaptrim-class work item: under
                # mclock it is paced by the snaptrim rates instead of
                # riding the map-change op's class
                self.daemon.op_wq.queue(self.pgid, self.trim_snaps,
                                        fresh, klass="snaptrim",
                                        priority=1)
        up, upp, acting, actp = m.pg_to_up_acting_osds(self.pgid)
        with self.lock:
            changed = acting != self.acting or actp != self.acting_primary
            self.up = up
            self.acting = acting
            self.acting_primary = actp
            if changed:
                self.interval += 1
                # a new interval invalidates the old activation: the
                # primary re-peers, replicas wait for its log
                self.peer_state = ("peering" if actp == self.whoami
                                   else "replica")
            elif self.peer_state == "idle":
                self.peer_state = ("peering" if actp == self.whoami
                                   else "replica")
                changed = True     # first sight of our role: peer once
            if changed and actp != self.whoami:
                # primary-side recovery bookkeeping is meaningless on a
                # replica; keeping it would wedge cleanliness checks
                # and steer a future primary's reads forever
                self.peer_missing.clear()
            if changed and self.whoami not in \
                    set(self.acting) | set(self.up):
                # we are a STRAY for this PG now: nobody will ever push
                # our missing objects; drop the bookkeeping (and any
                # parked ops — the client retargets by map)
                self.missing.clear()
                self._missing_src.clear()
                self._missing_waiters.clear()
        if changed:
            # a new interval invalidates every reservation this PG
            # holds or waits on, in BOTH roles: the primary's round
            # restarts against the new acting set, and remote slots we
            # granted a (possibly dead) primary must not leak
            self._release_reservations()
            # a new interval invalidates this PG's tier residency: the
            # resident copies were the OLD primary's view, and another
            # primary may have written while we were not it
            tier = getattr(self.daemon, "hbm_tier", None)
            if tier is not None:
                tier.drop_prefix(str(self.pgid))
        if changed and self.is_primary():
            self.daemon.queue_recovery(self)
        if not self.is_primary():
            # replicas don't gate anything locally; release waiters
            with self.lock:
                waiting, self.waiting_for_active = \
                    self.waiting_for_active, []
            for fn in waiting:
                fn()

    def active_for_write(self) -> bool:
        with self.lock:
            alive = sum(1 for o in self.acting if o != CRUSH_ITEM_NONE)
            return alive >= self.pool.min_size and self.is_primary() \
                and self.peer_state == "active"

    def active_for_read(self) -> bool:
        with self.lock:
            if self.peer_state != "active":
                return False
            alive = sum(1 for o in self.acting if o != CRUSH_ITEM_NONE)
            if self.pool.is_erasure():
                k = self.backend.codec.get_data_chunk_count()
                return alive >= k and self.is_primary()
            return self.is_primary()

    # -- cache tiering -------------------------------------------------

    def _tier(self):
        """Per-PG cache-tier state (the reference's osd/tiering.py
        PGTier), lazily attached. PGTier does its base-pool IO through
        the RADOS client, which the port does not have yet: a cache-tier
        op fails here, loudly, instead of being served."""
        raise NotImplementedError(
            "cache tiering (PGTier) waits for the port's RADOS client "
            "slice; pool %r is a cache tier"
            % getattr(self.pool, "name", self.pgid.pool))

    def submit_internal_write(self, oid, t: PGTransaction,
                              logical_size, on_commit,
                              deleting: bool = False) -> bool:
        """Apply an OSD-internal mutation (promote install, dirty
        clear, evict, hit-set archive) through the normal replicated
        backend so replicas and the PG log stay consistent — the tier
        machinery must never write the store behind the log's back.

        Returns False WITHOUT submitting when this daemon is no longer
        the active primary: deferred tier work (an agent pass queued
        seconds ago) must not mint versions on a demoted primary's
        stale chain — a zombie agent could otherwise delete an object
        the NEW primary just rewrote."""
        with self.lock:
            if not self.is_primary() or self.peer_state != "active":
                return False
            self.last_version += 1
            version = self.last_version
        if not deleting:
            t.setattr(oid, VERSION_ATTR, str(version).encode())
            if logical_size is not None:
                t.setattr(oid, "_size", str(logical_size).encode())
        self.backend.submit_transaction(t, version, on_commit)
        return True

    # -- client op execution (PrimaryLogPG::do_op collapsed) -----------

    def do_op(self, msg, reply_fn) -> None:
        # per-principal attribution (osd/perf_query.py): wrap the
        # reply ONCE per op — do_op re-enters through missing-object
        # parking and waiting_for_active with the same msg+reply_fn,
        # and a second wrap would double-count the op
        pq = getattr(self.daemon, "perf_query", None)
        if pq is not None and pq.active \
                and not getattr(msg, "_pq_wrapped", False):
            msg._pq_wrapped = True
            reply_fn = pq.wrap_reply(
                msg, reply_fn,
                getattr(self.pool, "name", str(self.pgid.pool)),
                self.pgid)
        if not self.is_primary():
            reply_fn(-11, None)  # EAGAIN: wrong primary / not peered
            return
        # a retransmit of a write some past primary already committed
        # (the reqid rides the replicated log) replays its outcome —
        # the exactly-once guarantee must survive failover, not just
        # live in one daemon's memory
        session = getattr(msg, "session", "")
        if session:
            with self.lock:
                done_v = self._reqids.get((session, msg.tid))
            if done_v is not None:
                reply_fn(0, done_v)
                return
        # an object we know we're missing must be recovered before any
        # op touches it — serving the local copy would expose stale
        # bytes for an acked write (PrimaryLogPG wait_for_missing).
        # Register-and-return under ONE lock hold: a second check after
        # registering would race a concurrent push into running the op
        # twice (once via the waiter, once here).
        parked = False
        repull = None
        with self.lock:
            if msg.oid in self.missing:
                parked = True
                self._missing_waiters.setdefault(msg.oid, []).append(
                    lambda: self._resume_parked(msg, reply_fn))
                now = _time.monotonic()
                if now - self._pulling.get(msg.oid, -1e9) > 2.0:
                    self._pulling[msg.oid] = now
                    repull = self._missing_src.get(msg.oid)
        if parked:
            if repull is not None:
                self.send_to_osd(repull, MOSDPGPull(
                    pgid=self.pgid, from_osd=self.whoami,
                    shard=(self.my_shard() if self.pool.is_erasure()
                           else -1),
                    oid=msg.oid, map_epoch=self.map_epoch()))
            return
        # cache-tier interposition (PrimaryLogPG::maybe_handle_cache):
        # a tier-pool PG may promote, proxy, or answer the op itself —
        # unless the client pinned the op to this pool (IGNORE_CACHE).
        # The explicit cache control ops are tier ops by definition and
        # ignore the flag.
        from ..msg.message import OSD_FLAG_IGNORE_CACHE
        if self.pool.is_tier() and self.pool.cache_mode != "none" \
                and self.active_for_read():
            op0 = msg.ops[0][0] if msg.ops else ""
            if (not (getattr(msg, "flags", 0) & OSD_FLAG_IGNORE_CACHE)
                    or op0 in ("cache_flush", "cache_try_flush",
                               "cache_evict")):
                if self._tier().maybe_handle(msg, reply_fn):
                    return
        if any(op[0] == "call" for op in msg.ops):
            self._do_call_op(msg, reply_fn)
            return
        if msg.ops and msg.ops[0][0] in ("watch", "unwatch", "notify"):
            self._do_watch_ops(msg, reply_fn)
            return
        from ..msg.message import OSD_READ_OPS
        reads = [op for op in msg.ops if op[0] in OSD_READ_OPS]
        if reads and len(reads) == len(msg.ops):
            self._do_read_ops(msg, reply_fn)
            return
        if not self.active_for_write():
            # hold until peered enough (waiting_for_active)
            with self.lock:
                self.waiting_for_active.append(
                    lambda: self.do_op(msg, reply_fn))
            return
        self._do_write_ops(msg, reply_fn)

    def _resume_parked(self, msg, reply_fn) -> None:
        """An op parked on a missing object resumes once it is pushed.
        A failure fails the op with EIO, as the daemon's op wrapper does
        for an op it runs, and propagates to the push that woke it."""
        try:
            self.do_op(msg, reply_fn)
        except Exception:
            reply_fn(-5, None)
            raise

    def _do_call_op(self, msg, reply_fn) -> None:
        """Object-class exec (PrimaryLogPG do_osd_ops CEPH_OSD_OP_CALL).

        Classes need synchronous local reads, which EC pools cannot
        serve (objects_read_sync -EOPNOTSUPP, ecbackend.rst:79-83) —
        so, like the reference, cls is refused on erasure pools.
        """
        from .objclass import CLS_METHOD_WR, ClassHandler, MethodContext
        if self.pool.is_erasure():
            reply_fn(-95, None)  # EOPNOTSUPP
            return
        if len(msg.ops) != 1:
            # mixing exec with other ops in one message would silently
            # drop the rest; reject the vector outright
            reply_fn(-22, None)  # EINVAL
            return
        _, cls_name, method_name, indata = msg.ops[0]
        method = ClassHandler.instance().get_method(cls_name, method_name)
        if method is None:
            reply_fn(-95, None)  # unknown class/method (reference: same)
            return
        if method.flags & CLS_METHOD_WR and not self.active_for_write():
            with self.lock:
                self.waiting_for_active.append(
                    lambda: self.do_op(msg, reply_fn))
            return
        hctx = MethodContext(self, msg.oid)
        try:
            ret, out = method.fn(hctx, indata)
        except Exception:
            reply_fn(-5, None)
            return
        if ret != 0 or not hctx.wrote:
            reply_fn(ret, out)
            return
        if not method.flags & CLS_METHOD_WR:
            reply_fn(-1, None)  # EPERM: RD-only method tried to write
            return
        with self.lock:
            self.last_version += 1
            version = self.last_version
        if not hctx.removed:  # a version xattr would resurrect the object
            hctx.txn.setattr(msg.oid, VERSION_ATTR, str(version).encode())
        self.backend.submit_transaction(
            hctx.txn, version, lambda: reply_fn(ret, out))

    # -- watch / notify (PrimaryLogPG do_osd_op_watch + do_notify) -----

    def _do_watch_ops(self, msg, reply_fn) -> None:
        op = msg.ops[0]
        kind = op[0]
        oid = msg.oid
        if kind == "watch":
            cookie = op[1]
            addr = tuple(msg.from_addr) if msg.from_addr else None
            if addr is None:
                reply_fn(-22, None)
                return
            with self.lock:
                self.watchers.setdefault(oid, {})[cookie] = addr
            reply_fn(0, None)
            return
        if kind == "unwatch":
            with self.lock:
                self.watchers.get(oid, {}).pop(op[1], None)
            reply_fn(0, None)
            return
        # notify: fan out to every watcher, complete when all ack or
        # the timeout fires (Objecter notify linger semantics)
        payload = op[1] if len(op) > 1 else b""
        timeout = op[2] if len(op) > 2 else 3.0
        with self.lock:
            watchers = dict(self.watchers.get(oid, {}))
            self._notify_seq += 1
            notify_id = (self.whoami << 32) | self._notify_seq
        if not watchers:
            reply_fn(0, {"replies": {}, "timed_out": []})
            return
        state = {"waiting": set(watchers), "replies": {},
                 "reply_fn": reply_fn}
        with self.lock:
            self._notifies[notify_id] = state
        for cookie, addr in watchers.items():
            self.daemon.send_to_client(addr, MWatchNotify(
                pgid=self.pgid, oid=oid, cookie=cookie,
                notify_id=notify_id, payload=payload,
                from_osd=self.whoami))
        self.daemon.timer.add_event_after(
            timeout or 3.0, self._notify_timeout, notify_id)

    def handle_notify_ack(self, msg) -> None:
        with self.lock:
            state = self._notifies.get(msg.notify_id)
            if state is None:
                return
            state["waiting"].discard(msg.cookie)
            state["replies"][msg.cookie] = msg.reply
            done = not state["waiting"]
            if done:
                self._notifies.pop(msg.notify_id, None)
        if done:
            state["reply_fn"](0, {"replies": state["replies"],
                                  "timed_out": []})

    def _notify_timeout(self, notify_id: int) -> None:
        with self.lock:
            state = self._notifies.pop(notify_id, None)
        if state is not None:
            state["reply_fn"](0, {"replies": state["replies"],
                                  "timed_out": sorted(state["waiting"])})

    def _do_read_ops(self, msg, reply_fn) -> None:
        if not self.active_for_read():
            with self.lock:
                self.waiting_for_active.append(
                    lambda: self.do_op(msg, reply_fn))
            return
        op = msg.ops[0]
        kind = op[0]
        oid = msg.oid
        snap = getattr(msg, "snap", 0)
        if kind == "list_snaps":
            ss = self._load_snapset(oid)
            head_alive = (self._object_size(oid) is not None
                          and not self._is_whiteout(oid))
            reply_fn(0, {
                "seq": ss["seq"],
                "clones": [{"id": c, "snaps": ss["snaps"].get(c, []),
                            "size": ss["sizes"].get(c, 0)}
                           for c in sorted(ss["clones"])],
                "head_exists": head_alive})
            return
        if snap:
            resolved = self._resolve_snap(oid, snap)
            if resolved is None or (
                    resolved == oid and (self._is_whiteout(oid)
                                         or self._object_size(oid)
                                         is None)):
                reply_fn(-2, None)   # did not exist at that snap
                return
            oid = resolved
        elif self._is_whiteout(oid) and kind in ("read", "stat",
                                                 "getxattr",
                                                 "getxattrs",
                                                 "omap_get"):
            reply_fn(-2, None)       # tombstone reads as absent
            return
        if kind == "stat":
            size = self._object_size(oid)
            if size is None:
                reply_fn(-2, None)
            else:
                reply_fn(0, {"size": size})
            return
        if kind == "getxattr":
            cid = self.cid_of_shard(self.my_shard())
            try:
                reply_fn(0, self.store.getattr(cid, oid, op[1]))
            except KeyError:
                reply_fn(-2, None)
            return
        if kind == "getxattrs":
            # CEPH_OSD_OP_GETXATTRS: every USER xattr
            cid = self.cid_of_shard(self.my_shard())
            try:
                attrs = self.store.getattrs(cid, oid)
            except KeyError:
                reply_fn(-2, None)
                return
            reply_fn(0, user_xattrs(attrs))
            return
        if kind == "omap_get":
            cid = self.cid_of_shard(self.my_shard())
            try:
                reply_fn(0, self.store.omap_get(cid, oid))
            except KeyError:
                reply_fn(-2, None)
            return
        if kind == "copy_get":
            self._do_copy_get(oid, reply_fn)
            return
        if kind == "list":
            from .tiering import HITSET_PREFIX
            cid = self.cid_of_shard(self.my_shard())
            reply_fn(0, [o for o in self.store.list_objects(cid)
                         if o != META_OID and not is_clone_oid(o)
                         and not (isinstance(o, str)
                                  and o.startswith(HITSET_PREFIX))])
            return
        # read (off, len)
        size = self._object_size(oid)
        if size is None:
            reply_fn(-2, None)
            return
        off, length = op[1], op[2]
        # clamp to the LOGICAL size: the EC backend's hinfo only knows
        # padded chunk-stream bounds (object_info_t.size analog)
        if length == 0:
            length = max(0, size - off)
        else:
            length = max(0, min(length, size - off))
        if length == 0:
            reply_fn(0, b"")
            return
        self._ec_read_with_retry(oid, off, length, reply_fn,
                                 trace=getattr(msg, "trace", None))

    def _do_copy_get(self, oid, reply_fn, tries: int = 0) -> None:
        """CEPH_OSD_OP_COPY_GET (the promote/copy-from fetch,
        src/osd/PrimaryLogPG.cc do_osd_ops COPY_GET): one op returning
        a CONSISTENT (data, user xattrs, omap, version) snapshot.
        Replicated pools read inline on the op-shard worker (writes
        serialize there, so the view is atomic); EC pools read data
        asynchronously, so the version is re-checked afterward and the
        fetch retried if a write landed in between."""
        size = self._object_size(oid)
        if size is None or self._is_whiteout(oid):
            reply_fn(-2, None)
            return
        v0 = self._object_version(oid)
        cid = self.cid_of_shard(self.my_shard())
        try:
            attrs = user_xattrs(self.store.getattrs(cid, oid))
        except KeyError:
            attrs = {}
        try:
            omap = dict(self.store.omap_get(cid, oid))
        except KeyError:
            omap = {}
        # the object's recent client reqids ride along (the reference
        # COPY_GET's reqids field): after a promote, the cache PG can
        # recognize a retransmit of a write the BASE pool already
        # applied — without this, a lost reply + resend across a tier
        # transition double-applies non-idempotent ops
        with self.lock:
            reqids = [(list(e.reqid), e.version)
                      for e in self.pg_log.entries
                      if e.oid == oid and e.reqid[0]]

        def finish(data):
            if data is None:
                reply_fn(-5, None)
                return
            if self._object_version(oid) != v0:
                if tries < 5:       # a write raced the async read
                    self._do_copy_get(oid, reply_fn, tries + 1)
                else:
                    reply_fn(-11, None)   # EAGAIN: hot object
                return
            reply_fn(0, {"data": bytes(data), "attrs": attrs,
                         "omap": omap, "version": v0,
                         "reqids": reqids})

        if size == 0:
            finish(b"")
        elif self.pool.is_erasure():
            self.backend.objects_read(oid, 0, size, finish)
        else:
            try:
                finish(self.store.read(self._head_cid(), oid))
            except KeyError:
                reply_fn(-2, None)

    def _ec_read_with_retry(self, oid, off, length, reply_fn,
                            attempt: int = 0, trace=None) -> None:
        """Reconstruction shortages are usually TRANSIENT (a shard
        mid-recovery is excluded from reads until its push commits):
        retry briefly before failing, like the reference holds ops on
        degraded objects instead of erroring (wait_for_degraded)."""
        def on_data(data):
            if data is not None:
                reply_fn(0, data)
            elif attempt < 20:
                self.daemon.timer.add_event_after(
                    0.5, self._ec_read_with_retry, oid, off, length,
                    reply_fn, attempt + 1, trace)
            else:
                reply_fn(-5, None)
        self.backend.objects_read(oid, off, length, on_data,
                                  trace=trace)

    def _object_size(self, oid):
        if self.pool.is_erasure():
            h = self.backend.get_hinfo(oid)
            if h.get_total_chunk_size() == 0:
                # distinguish empty object from absent
                st = self.store.stat(self.cid_of_shard(self.my_shard()),
                                     oid)
                return 0 if st is not None else None
            # logical size tracked via size xattr for exactness
            raw = self.local_getattr(oid, "_size")
            if raw is not None:
                return int(raw)
            return h.get_total_logical_size(self.backend.sinfo)
        st = self.store.stat(self.cid_of_shard(-1), oid)
        return st["size"] if st is not None else None

    # -- snapshots (PrimaryLogPG make_writeable / snapset machinery) ---

    def _load_snapset(self, oid) -> dict:
        raw = self.local_getattr(oid, SNAPSET_ATTR)
        if raw:
            try:
                return encoding.decode_any(raw)
            except encoding.DecodeError:
                pass
        return {"seq": 0, "clones": [], "snaps": {}, "sizes": {}}

    def _is_whiteout(self, oid) -> bool:
        return self.local_getattr(oid, WHITEOUT_ATTR) is not None

    def _head_cid(self):
        return self.cid_of_shard(-1)

    def _snap_capture_needed(self, oid, snapc) -> bool:
        """Will make_writeable need the head's BYTES? (EC pools must
        pre-read them through the backend before planning the write.)"""
        if not snapc or not snapc[0]:
            return False
        if self._object_size(oid) is None or self._is_whiteout(oid):
            return False
        ss = self._load_snapset(oid)
        seq, snaps = snapc[0], list(snapc[1] or ())
        return bool([s for s in snaps if s > ss["seq"]]) \
            and seq > ss["seq"]

    def make_writeable(self, t: PGTransaction, oid, snapc,
                       head_data: bytes | None = None) -> None:
        """Before the first mutation of a write whose SnapContext names
        snaps newer than the newest clone, preserve the current head as
        a clone covering them (PrimaryLogPG::make_writeable,
        PrimaryLogPG.cc around :3151 execute_ctx). The clone is emitted
        as captured bytes (not a store-level clone op) so it is
        pre-mutation by construction and replicas apply it
        deterministically — and on EC pools the captured clone encodes
        through the normal write path like any object (head_data is the
        pre-read logical content the caller gathered via the backend).

        Returns the in-flight snapset (so later ops in the SAME
        transaction see the new clone), or None when nothing was
        preserved."""
        if not snapc or not snapc[0]:
            return None
        seq, snaps = snapc[0], list(snapc[1] or ())
        size = self._object_size(oid)
        if size is None or self._is_whiteout(oid):
            # the object is being BORN under this SnapContext: stamp
            # the snapset seq so snap reads older than its birth
            # resolve to "did not exist" (object_info/snapset seq
            # semantics), keeping any clones a prior life left behind
            ss = self._load_snapset(oid)
            if seq > ss["seq"]:
                ss["seq"] = seq
                t.setattr(oid, SNAPSET_ATTR, encoding.encode_any(ss))
                return ss
            return None            # no head to preserve
        if not self._snap_capture_needed(oid, snapc):
            return None            # the ONE capture predicate
        ss = self._load_snapset(oid)
        new_snaps = sorted(s for s in snaps if s > ss["seq"])
        if self.pool.is_erasure() and head_data is None:
            # the pre-read didn't arrive (predicate/state drift): skip
            # the clone rather than read the dataless EC head cid
            return None
        cname = clone_name(oid, seq)
        if head_data is not None:
            data = head_data
            cid = self.cid_of_shard(self.my_shard())
        else:
            cid = self._head_cid()
            data = self.store.read(cid, oid)
        t.create(cname)
        if data:
            t.write(cname, 0, data)
        t.setattr(cname, VERSION_ATTR,
                  str(self._object_version(oid)).encode())
        t.setattr(cname, "_size", str(size).encode())
        try:
            omap = self.store.omap_get(cid, oid)
        except KeyError:
            omap = {}
        if omap:
            t.omap_setkeys(cname, omap)
        ss["clones"].append(seq)
        ss["clones"].sort()
        ss["snaps"][seq] = new_snaps
        ss["sizes"][seq] = size
        ss["seq"] = seq
        t.setattr(oid, SNAPSET_ATTR, encoding.encode_any(ss))
        return ss

    def _resolve_snap(self, oid, snap: int):
        """Which stored object serves reads at snap id `snap`?
        Clone c covers snaps in (previous clone, c]; newer than the
        newest clone reads from head — unless the head was born after
        the snap (snapset seq > snap with no covering clone), which is
        'did not exist then': None."""
        ss = self._load_snapset(oid)
        for c in sorted(ss["clones"]):
            if c >= snap:
                covered = ss["snaps"].get(c, [])
                if covered and snap < min(covered):
                    # the clone's coverage starts after `snap`: the
                    # object was born between them — did not exist
                    return None
                return clone_name(oid, c)
        if ss["seq"] >= snap:
            # no covering clone and the head's (re)birth context
            # already included `snap`: the object did not exist then
            # (a write under snapc seq S postdates every snap <= S)
            return None
        return oid                  # head

    def trim_snaps(self, removed: list) -> None:
        """Drop removed snaps from clone coverage; clones covering
        nothing are deleted (snap trimming; each OSD trims its own
        store deterministically from the map's removed_snaps). EC
        shard collections trim independently — the snapset xattr is
        replicated to every shard."""
        if not removed:
            return
        removed = set(removed)
        cids = ([self._head_cid()] if not self.pool.is_erasure()
                else [self.cid_of_shard(s)
                      for s in range(self.pool.size)])
        for cid in cids:
            self._trim_snaps_cid(cid, removed)

    def _trim_snaps_cid(self, cid, removed: set) -> None:
        for oid in list(self.store.list_objects(cid)):
            if is_clone_oid(oid) or oid == META_OID:
                continue
            raw = None
            try:
                raw = self.store.getattr(cid, oid, SNAPSET_ATTR)
            except KeyError:
                continue
            if not raw:
                continue
            try:
                ss = encoding.decode_any(raw)
            except encoding.DecodeError:
                continue
            dirty = False
            txn = Transaction()
            for c in list(ss["clones"]):
                keep = [s for s in ss["snaps"].get(c, [])
                        if s not in removed]
                if keep != ss["snaps"].get(c, []):
                    dirty = True
                if keep:
                    ss["snaps"][c] = keep
                else:
                    ss["clones"].remove(c)
                    ss["snaps"].pop(c, None)
                    ss["sizes"].pop(c, None)
                    txn.remove(cid, clone_name(oid, c))
            if dirty:
                try:
                    wout = self.store.getattr(
                        cid, oid, WHITEOUT_ATTR) is not None
                except KeyError:
                    wout = False
                if not ss["clones"] and wout:
                    # nothing references the whiteout anymore
                    txn.remove(cid, oid)
                else:
                    txn.setattr(cid, oid, SNAPSET_ATTR,
                                encoding.encode_any(ss))
                self.store.queue_transaction(txn)

    def _do_write_ops(self, msg, reply_fn) -> None:
        """EC pools read asynchronously, so snapshot captures (COW of
        the pre-write head, rollback source content) pre-read through
        the backend before the write is planned; replicated pools read
        their local store inline."""
        snapc = getattr(msg, "snapc", (0, ()))
        mutates = any(op[0] in ("write", "writefull", "append", "zero",
                                "truncate", "remove", "rollback")
                      for op in msg.ops)
        if not (self.pool.is_erasure() and mutates):
            self._plan_write_ops(msg, reply_fn, {})
            return
        # EC: mutations on one object run one at a time so the async
        # pre-read can never capture a head another in-flight write is
        # changing (the EC backend pipeline then keeps submit order)
        from collections import deque

        def run():
            self._ec_write_with_prereads(msg, reply_fn)

        with self.lock:
            q = self._obj_gate.setdefault(msg.oid, deque())
            q.append(run)
            if len(q) > 1:
                return             # a predecessor will run us
        run()

    def _release_obj_gate(self, oid) -> None:
        nxt = None
        with self.lock:
            q = self._obj_gate.get(oid)
            if q:
                q.popleft()
                if q:
                    nxt = q[0]
                else:
                    self._obj_gate.pop(oid, None)
        if nxt is not None:
            nxt()

    def _ec_write_with_prereads(self, msg, reply_fn) -> None:
        snapc = getattr(msg, "snapc", (0, ()))
        needs: list = []
        if self._snap_capture_needed(msg.oid, snapc):
            needs.append(msg.oid)
        for op in msg.ops:
            if op[0] == "rollback":
                src_oid = self._resolve_snap(msg.oid, op[1])
                if src_oid not in (None, msg.oid):
                    needs.append(src_oid)

        # The gate must stay held until the write COMMITS, not merely
        # until it is planned/submitted: the snapset update rides the
        # async shard transactions, so a successor entering the gate
        # pre-commit would read a stale snapset and capture a second
        # clone from a post-write head (PrimaryLogPG holds the
        # ObjectContext rw-lock across make_writeable -> commit the
        # same way, PrimaryLogPG.cc:5197-5311).
        released = [False]

        def release_once():
            with self.lock:
                if released[0]:
                    return
                released[0] = True
            self._release_obj_gate(msg.oid)

        def finish(result, data):
            try:
                reply_fn(result, data)
            finally:
                release_once()

        def plan(pre):
            try:
                self._plan_write_ops(msg, finish, pre)
            except Exception:
                # fail the op rather than unwind into the backend's
                # read-completion / timer context (finish releases the
                # gate); the client sees EIO instead of a 30s timeout
                logging.getLogger("ceph_tpu_torch.osd").exception(
                    "EC write planning failed for %r", msg.oid)
                finish(-5, None)

        if not needs:
            plan({})
            return
        pre: dict = {}

        def read_next(i: int, attempt: int = 0) -> None:
            if i == len(needs):
                plan(pre)
                return
            roid = needs[i]
            size = self._object_size(roid)
            if size is None:
                finish(-2, None)   # pre-read source vanished
                return

            def on_data(data, roid=roid, i=i):
                if data is None:
                    # degraded below k / reconstruction failed: b""
                    # here would snapshot or roll back to EMPTY content
                    # and ack it. Usually TRANSIENT (shard mid-recovery
                    # excluded from reads): retry briefly, then error
                    if attempt < 10:
                        self.daemon.timer.add_event_after(
                            0.5, read_next, i, attempt + 1)
                    else:
                        finish(-5, None)
                    return
                pre[roid] = bytes(data)
                read_next(i + 1)

            if size == 0:
                on_data(b"")
            else:
                self.backend.objects_read(
                    roid, 0, size, on_data,
                    trace=getattr(msg, "trace", None))

        read_next(0)

    def _plan_write_ops(self, msg, reply_fn, pre: dict) -> None:
        t = PGTransaction()
        oid = msg.oid
        snapc = getattr(msg, "snapc", (0, ()))
        mutates = any(op[0] in ("write", "writefull", "append", "zero",
                                "truncate", "remove", "rollback")
                      for op in msg.ops)
        ss_inflight = None
        if mutates:
            ss_inflight = self.make_writeable(t, oid, snapc,
                                              head_data=pre.get(oid))
        if self._is_whiteout(oid):
            # recreating over a whiteout: clear the tombstone, keep ss
            if any(op[0] in ("create", "write", "writefull", "append")
                   for op in msg.ops):
                t.rmattr(oid, WHITEOUT_ATTR)
        logical_size = self._object_size(oid) or 0
        for op in msg.ops:
            kind = op[0]
            if kind == "create":
                t.create(oid)
            elif kind == "write":
                t.write(oid, op[1], op[2])
                logical_size = max(logical_size, op[1] + len(op[2]))
            elif kind == "writefull":
                # CEPH_OSD_OP_WRITEFULL replaces the DATA only: xattrs
                # (snapset!) and omap persist (do_osd_ops WRITEFULL is
                # truncate+write, not delete+create — a remove here
                # would wipe the head's snapset whenever a later writer
                # needs no capture, losing every existing clone).
                # Earlier data ops in the SAME transaction are
                # superseded wholesale — including a whiteout marker a
                # preceding remove queued (the object is being reborn).
                t.reset_data(oid)
                t.drop_attr_update(oid, WHITEOUT_ATTR)
                if self._object_size(oid) is not None:
                    t.truncate(oid, 0)
                t.create(oid)
                t.write(oid, 0, op[1])
                logical_size = len(op[1])
            elif kind == "append":
                t.write(oid, logical_size, op[1])
                logical_size += len(op[1])
            elif kind == "zero":
                t.zero(oid, op[1], op[2])
            elif kind == "truncate":
                t.truncate(oid, op[1])
                logical_size = op[1]
            elif kind == "remove":
                ss = ss_inflight or self._load_snapset(oid)
                if ss["clones"] or self.pool.is_tier():
                    # live clones still reference the snapset — and a
                    # cache tier must REMEMBER deletions so the flush
                    # propagates them to the base pool: leave a
                    # whiteout tombstone instead of erasing it
                    # (PrimaryLogPG whiteout semantics)
                    t.truncate(oid, 0)
                    t.setattr(oid, WHITEOUT_ATTR, b"1")
                else:
                    t.remove(oid)
                logical_size = 0
            elif kind == "rollback":
                # CEPH_OSD_OP_ROLLBACK: head becomes the clone that
                # serves snap op[1]; rolling back to head is a no-op
                src = self._resolve_snap(oid, op[1])
                if src is None:
                    # the object did not exist at that snap: rollback
                    # means delete (whiteout if clones remain)
                    ss = ss_inflight or self._load_snapset(oid)
                    if ss["clones"]:
                        t.truncate(oid, 0)
                        t.setattr(oid, WHITEOUT_ATTR, b"1")
                    else:
                        t.remove(oid)
                    logical_size = 0
                elif src != oid:
                    if src in pre:
                        data = pre[src]     # EC: pre-read via backend
                    else:
                        cid = self._head_cid()
                        try:
                            data = self.store.read(cid, src)
                        except KeyError:
                            reply_fn(-2, None)
                            return
                    ss = ss_inflight or self._load_snapset(oid)
                    t.remove(oid)
                    t.create(oid)
                    if data:
                        t.write(oid, 0, data)
                    t.setattr(oid, SNAPSET_ATTR,
                              encoding.encode_any(ss))
                    logical_size = len(data)
                elif self._is_whiteout(oid) or \
                        self._object_size(oid) is None:
                    reply_fn(-2, None)
                    return
            elif kind == "setxattr":
                t.setattr(oid, op[1], op[2])
            elif kind == "rmxattr":
                t.rmattr(oid, op[1])
            elif kind == "resetxattrs":
                # drop every USER xattr — persisted AND ones queued
                # earlier in this same op vector (the metadata-
                # replacement leg of a tier flush: copy-from
                # semantics, the base must not keep attrs the cache
                # deleted)
                cid = self.cid_of_shard(self.my_shard())
                try:
                    names = set(self.store.getattrs(cid, oid))
                except KeyError:
                    names = set()
                pending = t.op_map.get(oid)
                if pending is not None:
                    names.update(k for k, v in
                                 pending.attr_updates.items()
                                 if v is not None)
                for name in names:
                    if is_user_xattr(name):
                        t.rmattr(oid, name)
            elif kind == "omap_set":
                t.omap_setkeys(oid, op[1])
            elif kind == "omap_rm":
                t.omap_rmkeys_op(oid, op[1])
            elif kind == "omap_clear":
                # CEPH_OSD_OP_OMAPCLEAR: persisted keys AND any queued
                # by an earlier omap_set in this op vector
                cid = self.cid_of_shard(self.my_shard())
                try:
                    keys = set(self.store.omap_get(cid, oid))
                except KeyError:
                    keys = set()
                pending = t.op_map.get(oid)
                if pending is not None:
                    keys.update(pending.omap_updates)
                if keys:
                    t.omap_rmkeys_op(oid, sorted(keys))
            else:
                reply_fn(-95, None)  # EOPNOTSUPP
                return
        with self.lock:
            self.last_version += 1
            version = self.last_version
        # version + logical size ride as xattrs on every shard; a
        # whiteout tombstone still exists physically and keeps them
        head_op = t.op_map.get(oid)
        still_exists = head_op is None or not head_op.is_delete()
        if still_exists:
            t.setattr(oid, VERSION_ATTR, str(version).encode())
            t.setattr(oid, "_size", str(logical_size).encode())
            if self.pool.is_tier() and \
                    self.pool.cache_mode in ("writeback", "readproxy"):
                # cache-tier dirty bit (object_info_t FLAG_DIRTY): the
                # agent flushes this object back to the base pool.
                # EVERY write message dirties — metadata-only ops
                # (rmxattr, omap_rm) included, or a deleted attr would
                # never flush and would resurrect from the base copy
                from .tiering import DIRTY_ATTR
                t.setattr(oid, DIRTY_ATTR, b"1")
                self._tier().dirty_at.setdefault(oid, _time.monotonic())
        self.backend.submit_transaction(
            t, version, lambda: reply_fn(0, version),
            reqid=(getattr(msg, "session", ""), msg.tid),
            trace=getattr(msg, "trace", None))

    # -- peering: GetInfo / GetLog / GetMissing ------------------------

    def start_recovery(self) -> None:
        """Entry point from the recovery queue: run the peering rounds
        (log-based convergence), then scan-backfill any peer whose log
        does not overlap.

        Peering storm control: when the daemon's peering
        gate is on, peering itself queues for a slot on the "peering"
        AsyncReserver — a map-churn burst re-peers at most
        osd_peering_max_active PGs concurrently instead of flooding
        the op queue with a thousand simultaneous info exchanges."""
        if not self.is_primary():
            return
        res = self._peering_reserver()
        if res is None:
            self.start_peering()
            return
        with self.lock:
            # the grant callback re-reads this, so a newer interval's
            # start_recovery retargets an already-queued request
            # (request_reservation ignores the duplicate item)
            self._peering_want = self.interval
        self._peering_slot = True
        res.request_reservation(str(self.pgid),
                                self._peering_granted,
                                _RESV_PRIO["peering"])

    def _peering_reserver(self):
        """The daemon's peering-slot reserver, or None when the gate
        is off (osd_peering_max_active=0) or the PG runs against a
        stub daemon — None short-circuits to ungated peering."""
        if not getattr(self.daemon, "peering_gate", False):
            return None
        reservers = self._reservers()
        if reservers is None:
            return None
        return reservers.get("peering")

    def _peering_granted(self) -> None:
        """Slot granted: run peering on the op queue's recovery class,
        never inline — the grant callback fires on whatever thread
        released the previous holder's slot."""
        queue = getattr(self.daemon, "op_wq", None)
        if queue is None:
            self._run_gated_peering()
            return
        queue.queue(self.pgid, self._run_gated_peering,
                    klass="recovery",
                    priority=getattr(self.daemon,
                                     "recovery_op_priority", 5))

    def _run_gated_peering(self) -> None:
        with self.lock:
            stale = (getattr(self, "_peering_want", -1)
                     != self.interval
                     or self.acting_primary != self.whoami)
        if stale:
            # the interval moved while we queued: the map change that
            # moved it already re-queued recovery, so just give the
            # slot back
            self._release_peering_slot()
            return
        self.start_peering()

    def _release_peering_slot(self) -> None:
        res = self._peering_reserver()
        if res is None or not getattr(self, "_peering_slot", False):
            return
        self._peering_slot = False
        res.cancel_reservation(str(self.pgid))

    def _my_info(self) -> dict:
        with self.lock:
            return {"osd": self.whoami,
                    "last_update": list(self.pg_log.head),
                    "log_tail": list(self.pg_log.tail)}

    def osds_missing_object(self, oid) -> set:
        """OSDs whose shard of `oid` is known-stale (their recovery
        push has not committed): reads must reconstruct around them."""
        with self.lock:
            bad = set(self.peer_missing.get(oid, ()))
            if oid in self.missing:
                bad.add(self.whoami)
            return bad

    def start_peering(self) -> None:
        with self.lock:
            self.peer_state = "peering"
            self._peer_seq += 1
            seq = self._peer_seq
            # wall-clock start for the ceph_pg_peering_seconds lane
            self._peer_t0 = _time.monotonic()
            self._peer_infos = {self.whoami: self._my_info()}
            # a new interval recomputes who is missing what: replicas
            # re-report after activation (handle_log missing notify)
            self.peer_missing.clear()
            self.backfilling.clear()
            targets = {osd for osd in set(self.up) | set(self.acting)
                       if osd not in (CRUSH_ITEM_NONE, self.whoami)}
            self._peer_wait = set(targets)
        if not targets:
            self._choose_authoritative(seq)
            return
        for osd in targets:
            self.send_to_osd(osd, MOSDPGQuery(
                pgid=self.pgid, from_osd=self.whoami, what="info",
                map_epoch=self.map_epoch()))
        # peers that never answer must not wedge the PG: after the
        # grace, proceed with whoever responded (they re-peer via a
        # later map change / backfill when they return)
        self.daemon.timer.add_event_after(
            0.5, self._peering_retry, seq, 0)

    def _peer_quorum(self) -> int:
        """How many infos (self included) we must hold before
        activating: enough that the responder set provably intersects
        ANY set that could have acked a write in a prior interval (the
        role of the reference's prior-interval maybe_went_rw gate).
        An ack set has >= min_size members out of `size`, so
        intersection needs responders > size - min_size, i.e.
        size - min_size + 1 — for size=3/min_size=2 that is 2; for
        size=2/min_size=1 it is 2 (both, the price of min_size=1).
        EC additionally needs k responders to reconstruct anything."""
        need = self.pool.size - min(self.pool.min_size,
                                    self.pool.size) + 1
        if self.pool.is_erasure():
            need = max(need, self.backend.codec.get_data_chunk_count())
        return min(need, self.pool.size)

    def _peering_retry(self, seq: int, attempt: int) -> None:
        with self.lock:
            if seq != self._peer_seq or self.peer_state != "peering":
                return
            waiting = set(self._peer_wait)
            if not waiting:
                return
            if attempt >= 2 and \
                    len(self._peer_infos) >= self._peer_quorum():
                # enough of the prior world answered: any acked write
                # is represented among the responders — proceed
                self._peer_wait = set()
                go = True
            else:
                go = False
        if go:
            self._choose_authoritative(seq)
            return
        # not safe to proceed (the acked state might live only on the
        # silent peers): keep asking — the PG stays inactive, exactly
        # like the reference's down/incomplete states, until enough
        # peers return or a map change restarts peering
        if attempt >= 2:
            # wedged on silent peers: give the peering slot back so an
            # incomplete PG can't pin the storm-control lane while it
            # waits (possibly forever) for the dead peers to return
            self._release_peering_slot()
        for osd in waiting:
            self.send_to_osd(osd, MOSDPGQuery(
                pgid=self.pgid, from_osd=self.whoami, what="info",
                map_epoch=self.map_epoch()))
        self.daemon.timer.add_event_after(
            0.5, self._peering_retry, seq, attempt + 1)

    def handle_query(self, msg) -> None:
        """Peer side of GetInfo/GetLog."""
        if msg.what == "info":
            self.send_to_osd(msg.from_osd, MOSDPGNotify(
                pgid=self.pgid, from_osd=self.whoami,
                info=self._my_info(), map_epoch=self.map_epoch()))
            return
        if msg.what == "log":
            since = tuple(msg.since)
            with self.lock:
                if self.pg_log.overlaps(since):
                    entries = [(e.epoch, e.version, e.oid, e.kind,
                                e.prior_version)
                               for e in self.pg_log.entries_since(since)]
                    contiguous = True
                else:
                    entries = self.pg_log.dump()
                    contiguous = False
                head = list(self.pg_log.head)
            self.send_to_osd(msg.from_osd, MOSDPGLog(
                pgid=self.pgid, from_osd=self.whoami, entries=entries,
                head=head, contiguous=contiguous,
                info=self._my_info(), map_epoch=self.map_epoch()))

    def handle_notify(self, msg) -> None:
        """Primary side: a peer's info (GetInfo reply) or its missing
        set (GetMissing leg, after it merged our activation log) —
        distinguished by the kind flag, because an EMPTY missing
        report must not masquerade as an info reply."""
        if getattr(msg, "kind", "info") == "recovered":
            # a peer applied its recovery push: its shard is clean
            # again and may serve reads
            with self.lock:
                for oid in msg.missing:
                    peers = self.peer_missing.get(oid)
                    if peers is not None:
                        peers.discard(msg.from_osd)
                        if not peers:
                            self.peer_missing.pop(oid, None)
                    backf = self.backfilling.get(oid)
                    if backf is not None:
                        backf.discard(msg.from_osd)
                        if not backf:
                            self.backfilling.pop(oid, None)
            # a drained lane gives its reservation slots back
            self._maybe_release_reservations()
            return
        if getattr(msg, "kind", "info") == "missing":
            shards = self.acting_shards()
            shard = next((s for s, o in shards.items()
                          if o == msg.from_osd), -1)
            if self.pool.is_erasure() and shard == -1:
                # a STRAY's report (the peer is no longer in the acting
                # set): it holds no shard to recover — ignore; the
                # stray clears its own state on its next map update
                return
            if not self.pool.is_erasure():
                if msg.from_osd not in set(self.acting) | set(self.up):
                    return
                shard = -1
            with self.lock:
                for oid in msg.missing:
                    self.peer_missing.setdefault(oid, set()).add(
                        msg.from_osd)
            for oid in msg.missing:
                self._push_object(oid, shard, msg.from_osd)
            return
        proceed = False
        with self.lock:
            if self.peer_state != "peering":
                return
            seq = self._peer_seq
            self._peer_infos[msg.from_osd] = dict(msg.info)
            self._peer_wait.discard(msg.from_osd)
            proceed = not self._peer_wait
        if proceed:
            self._choose_authoritative(seq)

    def _choose_authoritative(self, seq: int) -> None:
        """GetLog: the highest last_update owns history."""
        with self.lock:
            if seq != self._peer_seq or self.peer_state != "peering":
                return
            if len(self._peer_infos) < self._peer_quorum():
                return   # unsafe: acked state may be on silent peers
            infos = dict(self._peer_infos)
            my_head = self.pg_log.head
        best_osd, best_lu = self.whoami, my_head
        for osd, info in infos.items():
            lu = tuple(info.get("last_update", (0, 0)))
            if lu > best_lu:
                best_osd, best_lu = osd, lu
        if best_osd == self.whoami:
            self._activate(seq)
            return
        with self.lock:
            # only THIS peer's reply may serve as the authoritative
            # log for this round — a delayed MOSDPGLog from an old
            # interval must not short-circuit peering
            self._getlog_from = best_osd
        self.send_to_osd(best_osd, MOSDPGQuery(
            pgid=self.pgid, from_osd=self.whoami, what="log",
            since=tuple(my_head), map_epoch=self.map_epoch()))
        # the authoritative peer may die mid-GetLog: re-run the rounds
        # (if its extra entries were acked they live on another
        # responder too; if not, they were never acknowledged)
        self.daemon.timer.add_event_after(
            1.5, self._getlog_timeout, seq)

    def _getlog_timeout(self, seq: int) -> None:
        with self.lock:
            if seq != self._peer_seq or self.peer_state != "peering":
                return
        self.start_peering()

    def handle_log(self, msg) -> None:
        """A log segment arrived: on a peering primary this is the
        authoritative GetLog reply; on a replica it is the activation
        delta from the primary."""
        entries = [entry_from_tuple(r) for r in msg.entries]
        if self.is_primary():
            with self.lock:
                if self.peer_state != "peering":
                    return
                if msg.from_osd != getattr(self, "_getlog_from", None):
                    return   # not the authoritative reply we asked for
                self._getlog_from = None
                seq = self._peer_seq
                updates, divergent = self.pg_log.merge(
                    entries, tuple(msg.head))
                self.last_version = max(self.last_version,
                                        self.pg_log.head[1])
            self._persist_log_full()
            self._rebuild_reqids()
            self._apply_log_updates(updates, msg.from_osd, divergent)
            self._activate(seq)
            return
        # replica: merge, then report what we now know we're missing
        with self.lock:
            updates, divergent = self.pg_log.merge(entries,
                                                   tuple(msg.head))
            self.last_version = max(self.last_version,
                                    self.pg_log.head[1])
        if entries or updates or divergent:
            # a caught-up replica's empty activation delta (sent so it
            # re-reports missing) must not cost a full log rewrite
            self._persist_log_full()
            self._rebuild_reqids()
        self._apply_log_updates(updates, msg.from_osd, divergent,
                                pull=False)
        # report the FULL outstanding missing map, not just newly-
        # discovered entries: a report sent while the primary still saw
        # us as a stray was ignored, and re-activation may deliver no
        # new log entries — without the full set, those objects would
        # never be pushed
        with self.lock:
            need = set(self.missing)
        self.send_to_osd(msg.from_osd, MOSDPGNotify(
            pgid=self.pgid, from_osd=self.whoami, missing=sorted(need),
            kind="missing", map_epoch=self.map_epoch()))

    def _apply_log_updates(self, updates: dict, source_osd: int,
                           divergent: set = frozenset(),
                           pull: bool = True) -> set:
        """Act on a merge result: version 0 means the object must not
        exist here (divergent create / authoritative delete) — remove
        it; a positive version goes into `missing` and (on the
        primary) is pulled from the authoritative peer. A DIVERGENT
        local copy is dropped first: its version xattr was minted by a
        dead-interval fork and must never win a version comparison
        against the authoritative copy. Returns the set of oids still
        missing locally."""
        need: set = set()
        my_shard = self.my_shard() if self.pool.is_erasure() else -1
        for oid, version in sorted(updates.items()):
            if version == 0 or oid in divergent:
                txn = Transaction()
                if self.pool.is_erasure():
                    for s in range(self.pool.size):
                        txn.remove(self.cid_of_shard(s), oid)
                else:
                    txn.remove(self.cid_of_shard(-1), oid)
                self.store.queue_transaction(txn)
                with self.lock:
                    self.missing.pop(oid, None)
                if version == 0:
                    continue
            if self._object_version(oid) >= version:
                continue            # already have it (or newer)
            need.add(oid)
            with self.lock:
                self.missing[oid] = version
                self._missing_src[oid] = source_osd
            if pull and source_osd != self.whoami:
                self._pulling[oid] = _time.monotonic()
                self.send_to_osd(source_osd, MOSDPGPull(
                    pgid=self.pgid, from_osd=self.whoami,
                    shard=my_shard, oid=oid,
                    map_epoch=self.map_epoch()))
        return need

    def _activate(self, seq: int) -> None:
        """Activation: ship every known peer the log delta it lacks
        (replicas merge + report missing), fall back to scan backfill
        for non-overlapping peers, release held client ops."""
        with self.lock:
            if seq != self._peer_seq or self.peer_state != "peering":
                return
            self.peer_state = "active"
            infos = dict(self._peer_infos)
            waiting, self.waiting_for_active = \
                self.waiting_for_active, []
            head = self.pg_log.head
            t0 = getattr(self, "_peer_t0", None)
        # peering done: free the storm-control slot and feed the
        # duration histogram (ceph_pg_peering_seconds p99)
        self._release_peering_slot()
        note = getattr(self.daemon, "note_peering_done", None)
        if note is not None and t0 is not None:
            note(_time.monotonic() - t0)
        shards = self.acting_shards()
        backfill = []
        for osd, info in infos.items():
            if osd == self.whoami:
                continue
            peer_lu = tuple(info.get("last_update", (0, 0)))
            if peer_lu == head:
                # log-caught-up, but the peer may still hold a missing
                # map whose earlier report was dropped or ignored
                # (e.g. it arrived while our lagging map saw the peer
                # as a stray) — an EMPTY activation delta makes it
                # re-report its full outstanding set via handle_log
                self.send_to_osd(osd, MOSDPGLog(
                    pgid=self.pgid, from_osd=self.whoami, entries=[],
                    head=list(head), contiguous=True,
                    map_epoch=self.map_epoch()))
                continue
            with self.lock:
                overlaps = self.pg_log.overlaps(peer_lu)
                if overlaps:
                    entries = [(e.epoch, e.version, e.oid, e.kind,
                                e.prior_version)
                               for e in
                               self.pg_log.entries_since(peer_lu)]
                else:
                    # divergent or forked peer: ship the FULL log so
                    # its merge can find the common point and roll its
                    # dead-interval entries back (never the scan lane,
                    # which would resurrect them as "newer versions")
                    entries = self.pg_log.dump()
                    if peer_lu < self.pg_log.tail:
                        # pre-history peer: the log can't cover it all
                        backfill.append(osd)
            self.send_to_osd(osd, MOSDPGLog(
                pgid=self.pgid, from_osd=self.whoami,
                entries=entries, head=list(head),
                contiguous=overlaps, map_epoch=self.map_epoch()))
        # non-overlapping peers (or peers that never answered) converge
        # through the scan/backfill lane
        silent = [osd for s, osd in shards.items()
                  if osd not in (CRUSH_ITEM_NONE, self.whoami)
                  and osd not in infos]
        for osd in set(backfill + silent):
            shard = next((s for s, o in shards.items() if o == osd), -1)
            self.send_to_osd(osd, MOSDPGScan(
                pgid=self.pgid, from_osd=self.whoami, shard=shard,
                op="request", map_epoch=self.map_epoch()))
        # reconcile our own shard(s) (objects only we lost)
        my_inv = self._local_inventory(self.my_shard())
        self._reconcile_inventory(self.my_shard(), self.whoami, my_inv)
        for fn in waiting:
            fn()

    def _local_inventory(self, shard: int) -> dict:
        cid = self.cid_of_shard(shard)
        inv = {}
        for oid in self.store.list_objects(cid):
            if oid == META_OID:
                # the durable-log object is per-OSD state: pushing it
                # would graft OUR log head onto a replica that has
                # none of the data behind it
                continue
            try:
                raw = self.store.getattr(cid, oid, VERSION_ATTR)
                inv[oid] = int(raw) if raw else 0
            except KeyError:
                inv[oid] = 0
        return inv

    def handle_scan(self, msg) -> None:
        if msg.op == "request":
            # a replica answers with its shard's inventory plus its
            # delete log, so a primary that was down during a delete
            # learns the object is a ghost instead of re-pushing it
            inv = self._local_inventory(
                msg.shard if self.pool.is_erasure() else -1)
            with self.lock:
                deleted = dict(self._deleted_log)
            self.send_to_osd(msg.from_osd, MOSDPGScan(
                pgid=self.pgid, from_osd=self.whoami, shard=msg.shard,
                op="reply", objects=inv, deleted=deleted,
                map_epoch=self.map_epoch()))
            return
        if msg.op == "scrub_request":
            inv = self._scrub_inventory(
                msg.shard if self.pool.is_erasure() else -1)
            self.send_to_osd(msg.from_osd, MOSDPGScan(
                pgid=self.pgid, from_osd=self.whoami, shard=msg.shard,
                op="scrub_reply", objects=inv,
                map_epoch=self.map_epoch()))
            return
        if msg.op == "scrub_reply":
            self._handle_scrub_reply(msg.from_osd, msg.shard,
                                     msg.objects)
            return
        # primary side: compare against authoritative inventory
        self._reconcile_inventory(msg.shard, msg.from_osd, msg.objects,
                                  getattr(msg, "deleted", {}) or {})

    # -- scrub (PG_STATE_SCRUBBING; PrimaryLogPG scrub + repair) --------

    def _scrub_inventory(self, shard: int) -> dict:
        """oid -> (version, crc32(data), size) for one shard.

        Tier-resident objects carrying fused-write device digests are
        verified with ZERO host hashing: the on-disk bytes are still
        read (silent disk bitrot must stay catchable — the write-time
        digest only says what the bytes SHOULD be), but their crc is
        computed on device (fused_transform.device_crc32) and the
        resident digest is the expected side, so the host never walks
        a crc loop for them.  Only non-resident objects fall back to
        host_crc32()."""
        cid = self.cid_of_shard(shard)
        tier = getattr(self.daemon, "hbm_tier", None)
        inv = {}
        for oid in self.store.list_objects(cid):
            if oid == META_OID:
                continue   # per-OSD durable log, not replicated data
            try:
                dig = None if tier is None or shard < 0 else \
                    self._digest_from_tier(tier, shard, oid)
                data = self.store.read(cid, oid)
                raw = self.store.getattr(cid, oid, VERSION_ATTR)
                if dig is not None:
                    from . import fused_transform
                    disk_crc = fused_transform.device_crc32(
                        data, device=getattr(self.daemon,
                                             "home_device", None))
                    inv[oid] = (int(raw) if raw else 0, disk_crc,
                                len(data))
                    continue
                inv[oid] = (int(raw) if raw else 0,
                            host_crc32(data), len(data))
            except (KeyError, OSError):
                inv[oid] = (-1, 0, 0)   # unreadable shard: scrub error
        return inv

    def _digest_from_tier(self, tier, shard: int, oid) -> int | None:
        """Device-computed crc for one resident shard, or None on a miss
        (not resident, evicted, adopted without digests, or a shard row
        past the digest row's end). Any other error propagates: a fault
        of the tier or the card must not turn into host hashing."""
        key = (str(self.pgid), oid)
        try:
            row = tier.shard_digests(key)
            codec = tier.codec_of(key) if row is not None else None
        except KeyError:
            return None
        if row is None:
            return None
        phys = shard
        if codec is not None:
            for i in range(codec.get_chunk_count()):
                if codec.chunk_index(i) == shard:
                    phys = i
                    break
        if phys >= len(row):
            return None
        return int(row[phys])

    def scrub(self, seq: int | None = None, deep: bool = False,
              repair: bool = False) -> dict | None:
        """Primary-driven scrub: collect per-object (version, crc, size)
        from every acting peer, compare against the local copy, and
        push repairs for mismatches. Returns immediately; results land
        in self.scrub_stats once all replies arrive.

        seq is the ticket minted by OSDDaemon.scrub_pg (None = direct
        call: mint one here); a superseded ticket aborts silently.

        deep=True on an EC pool additionally verifies every shard's
        stored crc against the write-time hinfo record and rebuilds
        divergent shards from the survivors (decode on the device) —
        the integrity check a shallow EC scrub cannot do.

        Whether flagged inconsistencies are actually REPAIRED is
        repair OR osd_scrub_auto_repair; with both off the scrub is
        detect-only, errors persist in self.scrub_errors, and the
        cluster raises OSD_SCRUB_ERRORS until a 'pg repair'
        (scrub_pg(..., repair=True)) rebuilds the bad copies."""
        if not self.is_primary():
            return None
        shards = self.acting_shards()
        with self.lock:
            if seq is None:
                self._scrub_seq = getattr(self, "_scrub_seq", 0) + 1
                seq = self._scrub_seq
            elif seq != getattr(self, "_scrub_seq", 0):
                return None  # a newer scrub_pg superseded this ticket
            self._scrub_deep = deep
            try:
                auto = self.daemon.ctx.conf.get_val(
                    "osd_scrub_auto_repair")
            except Exception:
                auto = True
            self._scrub_repair = repair or auto
            self._scrub_waiting = {
                osd for shard, osd in shards.items()
                if osd not in (CRUSH_ITEM_NONE, self.whoami)}
            self._scrub_replies = {}
            self.scrub_stats = {"state": "scrubbing", "errors": 0,
                                "repaired": 0, "objects": 0}
        self._send_scrub_requests(shards)
        if not self._scrub_waiting:
            self._finish_scrub()
        else:
            # one-shot messages wedge on lossy links: retransmit to
            # laggard peers a few times, then give up loudly
            self.daemon.timer.add_event_after(
                1.0, self._scrub_retry, seq, 0)
        return self.scrub_stats

    def _send_scrub_requests(self, shards, only: set | None = None):
        for shard, osd in shards.items():
            if osd in (CRUSH_ITEM_NONE, self.whoami):
                continue
            if only is not None and osd not in only:
                continue
            self.send_to_osd(osd, MOSDPGScan(
                pgid=self.pgid, from_osd=self.whoami, shard=shard,
                op="scrub_request", map_epoch=self.map_epoch()))

    def _scrub_retry(self, seq: int, attempt: int) -> None:
        with self.lock:
            if seq != getattr(self, "_scrub_seq", 0) \
                    or not self._scrub_waiting:
                return  # this scrub finished or was superseded
            waiting = set(self._scrub_waiting)
            if attempt >= 5:
                self._scrub_waiting = set()
                self.scrub_stats = {"state": "failed", "errors": 0,
                                    "repaired": 0, "objects": 0,
                                    "unreachable": sorted(waiting)}
                return
        self._send_scrub_requests(self.acting_shards(), only=waiting)
        self.daemon.timer.add_event_after(
            1.0, self._scrub_retry, seq, attempt + 1)

    def _handle_scrub_reply(self, peer_osd: int, shard: int,
                            inv: dict) -> None:
        with self.lock:
            if peer_osd not in getattr(self, "_scrub_waiting", set()):
                return
            self._scrub_waiting.discard(peer_osd)
            self._scrub_replies[(peer_osd, shard)] = inv
            done = not self._scrub_waiting
        if done:
            self._finish_scrub()

    def _finish_scrub(self) -> None:
        """Compare every replica's inventory to the primary's copy.

        Replicated pools only compare like-for-like copies; EC shards
        hold different bytes per shard, so EC scrub checks only version
        presence (deep EC parity verification = decode check, a later
        round). Authoritative copy = highest version, primary wins
        ties; mismatches are repaired by pushing it."""
        with self.lock:
            seq = getattr(self, "_scrub_seq", 0)
            deep = getattr(self, "_scrub_deep", False)
            repair = getattr(self, "_scrub_repair", True)
            replies = {k: dict(v)
                       for k, v in self._scrub_replies.items()}
        local = self._scrub_inventory(
            self.my_shard() if self.pool.is_erasure() else -1)
        errors = repaired = 0
        shallow_repaired: set = set()   # (peer_osd, shard, oid)
        replicated = not self.pool.is_erasure()
        for (peer_osd, shard), inv in replies.items():
            for oid in set(local) | set(inv):
                mine = local.get(oid)
                theirs = inv.get(oid)
                if mine == theirs:
                    continue
                if not replicated:
                    # EC: only flag version divergence
                    if mine is not None and theirs is not None \
                            and mine[0] == theirs[0]:
                        continue
                errors += 1
                if repair and mine is not None and (
                        theirs is None or theirs[0] <= mine[0]):
                    self._push_object(oid, shard, peer_osd, force=True)
                    shallow_repaired.add((peer_osd, shard, oid))
                    repaired += 1
        if not replicated and deep:
            # the deep pass reconstructs objects through the normal EC
            # read path, whose sub-read replies are served by THIS PG's
            # shard worker — run it on its own thread so waiting for
            # them cannot deadlock the worker
            def deep_worker(base_err=errors, base_rep=repaired,
                            nobj=len(local)):
                d_err, d_rep = self._deep_scrub_ec(
                    local, replies, shallow_repaired, repair)
                err, rep = base_err + d_err, base_rep + d_rep
                with self.lock:
                    if seq != getattr(self, "_scrub_seq", 0):
                        return  # a newer scrub superseded this one
                    self.scrub_stats = {
                        "state": "clean" if err == rep
                        else "inconsistent",
                        "errors": err, "repaired": rep,
                        "objects": nobj, "deep": True}
                self._scrub_epilogue(err, rep, deep=True)

            threading.Thread(target=deep_worker, name="deep-scrub",
                             daemon=True).start()
            return
        with self.lock:
            if seq != getattr(self, "_scrub_seq", 0):
                return  # superseded mid-finish: don't clobber stats
            stats = {
                "state": "clean" if errors == repaired
                else "inconsistent",
                "errors": errors, "repaired": repaired,
                "objects": len(local)}
            if deep:
                # for replicated pools the shallow crc comparison IS
                # the deep check (all copies hold identical bytes);
                # mark completion either way so pollers keying on the
                # 'deep' flag terminate
                stats["deep"] = True
            self.scrub_stats = stats
        self._scrub_epilogue(errors, repaired, deep=deep)

    def _scrub_epilogue(self, errors: int, repaired: int,
                        deep: bool = False) -> None:
        """Post-scrub accounting: persist the unrepaired count for the
        pg-stats report (OSD_SCRUB_ERRORS input) and tell the operator
        through the cluster log — the reference clogs scrub results
        from PG::scrub_finish the same way."""
        with self.lock:
            self.scrub_errors = max(0, errors - repaired)
        clog = getattr(self.daemon, "clog", None)
        if clog is None:
            return
        what = "deep-scrub" if deep else "scrub"
        if errors:
            clog.error("pg %s %s: %d errors, %d repaired%s"
                       % (self.pgid, what, errors, repaired,
                          "" if errors == repaired
                          else " — pg is INCONSISTENT, run pg repair"))

    def _deep_scrub_ec(self, local_inv: dict, replies: dict,
                       already_repaired: set,
                       repair: bool = True) -> tuple[int, int]:
        """EC shard verification against the write-time hinfo crcs.

        Ground truth is the per-shard cumulative crc recorded at encode
        time (ECUtil.HashInfo) — NOT a reconstruction, which would
        trust whichever shards it happened to read and could launder a
        corrupt data shard into "authoritative" bytes. A divergent
        shard is rebuilt from the OTHER shards (recover_object excludes
        the target), the rebuilt bytes are re-verified against the
        hinfo crc, and only then force-pushed.  repair=False counts
        errors without rebuilding (detect-only deep scrub).
        """
        import zlib

        errors = repaired = 0
        shards = self.acting_shards()
        my_shard = self.my_shard()
        my_inv = {my_shard: local_inv}   # _finish_scrub computed this
        for s in shards:
            if shards[s] == self.whoami and s not in my_inv:
                my_inv[s] = self._scrub_inventory(s)
        for oid, (version, _, _) in sorted(local_inv.items()):
            h = self.backend.get_hinfo(oid)
            if not h.has_chunk_hash() or h.get_total_chunk_size() == 0:
                continue
            for shard, osd in shards.items():
                if osd == CRUSH_ITEM_NONE:
                    continue
                if (osd, shard, oid) in already_repaired:
                    continue   # the shallow pass just fixed this copy
                want_crc = h.get_chunk_hash(shard)
                if osd == self.whoami:
                    have = my_inv.get(shard, {}).get(oid)
                else:
                    have = replies.get((osd, shard), {}).get(oid)
                if have is not None and have[1] == want_crc:
                    continue
                errors += 1
                if not repair:
                    continue    # detect-only pass: count, don't touch
                done = threading.Event()
                got: list = [None]

                def on_done(data, _g=got, _d=done):
                    _g[0] = data
                    _d.set()

                self.backend.recover_object(oid, shard, on_done)
                if not done.wait(10.0) or got[0] is None:
                    continue    # unrepairable now: stays inconsistent
                rebuilt = bytes(got[0])
                if (zlib.crc32(rebuilt) & 0xFFFFFFFF) != want_crc:
                    continue    # survivors are bad too: do NOT launder
                attrs, omap = self._gather_push_meta(oid)
                attrs.setdefault(VERSION_ATTR, str(version).encode())
                push = MOSDPGPush(
                    pgid=self.pgid, from_osd=self.whoami, shard=shard,
                    oid=oid, data=rebuilt, attrs=attrs, omap=omap,
                    version=version, map_epoch=self.map_epoch(),
                    force=True)
                if osd == self.whoami:
                    self.handle_push(push)
                else:
                    self.send_to_osd(osd, push)
                repaired += 1
                self.daemon.perf.inc("repaired")
        return errors, repaired

    def get_stats(self) -> dict:
        """Primary's per-PG stats row for the mon's MPGStats report:
        the HealthMonitor derives OSD_SCRUB_ERRORS and POOL_FULL from
        these.  bytes/objects are the PRIMARY SHARD's stored footprint
        (for EC that is ~1/k of logical bytes — a quota knob, not an
        accounting ledger)."""
        cid = self.cid_of_shard(
            self.my_shard() if self.pool.is_erasure() else -1)
        nobj = nbytes = 0
        try:
            for oid in self.store.list_objects(cid):
                if oid == META_OID:
                    continue
                st = self.store.stat(cid, oid)
                if st is not None:
                    nobj += 1
                    nbytes += st.get("size", 0)
        except Exception:
            pass
        with self.lock:
            # pg_stat_t degraded/misplaced: degraded = object copies
            # a current acting member is known to lack (our own
            # missing set + every peer's); misplaced = copies still
            # being backfilled onto a new acting member (fully
            # readable elsewhere). These ride MPGStats/MMgrReport
            # into the mgr's pg_summary and the progress module.
            degraded = (len(self.missing)
                        + sum(len(s)
                              for s in self.peer_missing.values()))
            misplaced = sum(len(s) for s in self.backfilling.values())
            # reservation visibility (recovery_wait/backfill_wait/
            # backfill_toofull PG states): suffixes on the ACTIVE state
            # only — "peering" stays exact for the progress module
            state = self.peer_state
            if state == "active":
                for lane in ("recovery", "backfill"):
                    s = self._resv_state[lane]
                    if s in ("local_wait", "remote_wait"):
                        state += "+%s_wait" % lane
                    elif s == "toofull":
                        state += "+%s_toofull" % lane
                    elif s == "granted":
                        state += ("+recovering" if lane == "recovery"
                                  else "+backfilling")
            return {"pool": self.pgid.pool, "state": state,
                    "objects": nobj, "bytes": nbytes,
                    "scrub_errors": self.scrub_errors,
                    "degraded_objects": degraded,
                    "misplaced_objects": misplaced}

    def repair_shard(self, oid, shard: int, peer_osd: int) -> None:
        """Read-path self-heal: a shard that served EIO or bad-crc
        bytes during a client read is rebuilt from the survivors and
        force-pushed back (the scrub-repair machinery, triggered by the
        read instead of a scrub pass).  Deduped per (oid, shard) so a
        burst of reads over one bad shard repairs it once."""
        key = (oid, shard)
        with self.lock:
            if self.acting_primary != self.whoami:
                return
            if key in self._repairing:
                return
            self._repairing.add(key)
        attrs, omap = self._gather_push_meta(oid)

        def on_data(data):
            with self.lock:
                self._repairing.discard(key)
            if data is None:
                return     # not enough survivors right now; a scrub
                           # or the next read retries
            if self.pool.is_erasure():
                # never launder: the rebuilt bytes must match the
                # write-time hinfo crc before they overwrite anything
                h = self.backend.get_hinfo(oid)
                if h.has_chunk_hash():
                    import zlib
                    if (zlib.crc32(bytes(data)) & 0xFFFFFFFF) != \
                            h.get_chunk_hash(shard):
                        return
            version = max(int(attrs.get(VERSION_ATTR, b"0") or 0),
                          self._log_version_of(oid))
            push = MOSDPGPush(
                pgid=self.pgid, from_osd=self.whoami, shard=shard,
                oid=oid, data=bytes(data), attrs=attrs, omap=omap,
                version=version, map_epoch=self.map_epoch(),
                force=True)
            if peer_osd == self.whoami:
                self.handle_push(push)
            else:
                self.send_to_osd(peer_osd, push)
            self.daemon.perf.inc("repaired")
            clog = getattr(self.daemon, "clog", None)
            if clog is not None:
                clog.info("pg %s: rewrote shard %d of %r on osd.%d "
                          "after read error" % (self.pgid, shard, oid,
                                                peer_osd))

        self.backend.recover_object(oid, shard, on_data)

    def _authoritative_inventory(self) -> dict:
        """Union of all local shard inventories (primary's knowledge)."""
        out = {}
        if self.pool.is_erasure():
            for shard in range(self.pool.size):
                for oid, v in self._local_inventory(shard).items():
                    out[oid] = max(out.get(oid, 0), v)
        for oid, v in self._local_inventory(-1).items():
            out[oid] = max(out.get(oid, 0), v)
        return out

    def _reconcile_inventory(self, shard: int, peer_osd: int,
                             peer_inv: dict,
                             peer_deleted: dict | None = None) -> None:
        peer_deleted = peer_deleted or {}
        want = self._authoritative_inventory()
        missing = [oid for oid, v in want.items()
                   if peer_inv.get(oid, -1) < v]
        for oid in missing:
            del_v = peer_deleted.get(oid, -1)
            if del_v >= want.get(oid, -1):
                # the peer deleted this at/after our version while we
                # were away: our copy is the ghost — adopt the delete
                # locally instead of resurrecting it onto the peer
                with self.lock:
                    if del_v > self._deleted_log.get(oid, -1):
                        self._deleted_log.pop(oid, None)
                        self._deleted_log[oid] = del_v
                txn = Transaction()
                if self.pool.is_erasure():
                    for s in range(self.pool.size):
                        txn.remove(self.cid_of_shard(s), oid)
                else:
                    txn.remove(self.cid_of_shard(-1), oid)
                self.store.queue_transaction(txn)
                continue
            # inventory reconcile = the backfill lane: the peer is a
            # (possibly new) acting member being brought up to the
            # authoritative set after a remap — its objects are
            # misplaced, not degraded
            with self.lock:
                self.backfilling.setdefault(oid, set()).add(peer_osd)
            self._push_object(oid, shard, peer_osd, lane="backfill")
        if peer_osd == self.whoami:
            return
        # The peer may be AHEAD of us: a revived primary that missed
        # writes must pull them before serving authoritatively, or
        # acked data reads as lost (the peering GetLog/GetMissing
        # role, collapsed onto version xattrs). Deletes that happened
        # while we were down are indistinguishable from new objects
        # without divergent-log handling — resurrection is the known
        # limitation here, data loss is not.
        behind = [oid for oid, v in peer_inv.items()
                  if want.get(oid, -1) < v]
        my_shard = self.my_shard() if self.pool.is_erasure() else -1
        now = _time.monotonic()
        for oid in behind:
            # the divergence oracle: if OUR log shows the object deleted
            # at or after the peer's version, the peer holds a ghost —
            # propagate the delete instead of resurrecting it
            with self.lock:
                del_v = self._deleted_log.get(oid, -1)
            if del_v >= peer_inv[oid]:
                self.send_to_osd(peer_osd, MOSDPGPush(
                    pgid=self.pgid, from_osd=self.whoami, shard=shard,
                    oid=oid, version=del_v,
                    map_epoch=self.map_epoch(), delete=True))
                continue
            # in-flight pull tracking: repeated scan replies during
            # churn must not multiply EC reconstructions of the same
            # object; re-pull only after a timeout (lost push)
            if now - self._pulling.get(oid, -1e9) < 5.0:
                continue
            self._pulling[oid] = now
            self.send_to_osd(peer_osd, MOSDPGPull(
                pgid=self.pgid, from_osd=self.whoami, shard=my_shard,
                oid=oid, map_epoch=self.map_epoch()))
        if peer_inv:
            maxv = max(peer_inv.values())
            with self.lock:
                # never mint versions below what the cluster has seen
                if maxv > self.last_version:
                    self.last_version = maxv

    def handle_pull(self, msg) -> None:
        """A (usually freshly revived) primary asks for our newer copy
        of an object: push it to the requester's shard."""
        self._push_object(msg.oid, msg.shard, msg.from_osd)

    def _gather_push_meta(self, oid) -> tuple[dict, dict]:
        """(attrs, omap) from our local shard for a recovery/repair
        push — handle_push removes+rewrites the target, so the push
        must carry the FULL metadata set or the target loses it. A
        whitelist here once dropped the SNAPSET xattr, so a recovered
        head forgot its clones and snap reads resolved to the head."""
        src_cid = self.cid_of_shard(
            self.my_shard() if self.pool.is_erasure() else -1)
        try:
            attrs = {k: v for k, v in
                     self.store.getattrs(src_cid, oid).items()
                     if v is not None}
        except (KeyError, NotImplementedError):
            attrs = {}
            for name in (VERSION_ATTR, "_size", "hinfo_key",
                         SNAPSET_ATTR, WHITEOUT_ATTR):
                try:
                    val = self.store.getattr(src_cid, oid, name)
                except KeyError:
                    val = None
                if val is not None:
                    attrs[name] = val
        try:
            omap = self.store.omap_get(src_cid, oid)
        except KeyError:
            omap = {}
        return attrs, omap

    def _push_object(self, oid, shard: int, peer_osd: int,
                     force: bool = False, attempt: int = 0,
                     lane: str = "recovery") -> None:
        # reservation gate (osd_max_backfills/osd_recovery_max_active):
        # a push may only run while this PG holds its lane's local AND
        # remote slots — otherwise it parks in _resv_pending and the
        # reservation round starts.  force (scrub/read repair) bypasses:
        # those are corrective rewrites of data already counted present.
        if not force and not self._holds_reservation(lane):
            entry = (oid, shard, peer_osd, attempt)
            with self.lock:
                if entry not in self._resv_pending[lane]:
                    self._resv_pending[lane].append(entry)
            self._request_reservations(lane)
            return
        # osd_recovery_sleep delay shaping (BackoffThrottle): the unit
        # is held for the push's lifetime, so concurrent pushes raise
        # occupancy and every subsequent get() sleeps longer
        throttle = None if force else getattr(
            self.daemon, "recovery_throttle", None)
        if throttle is not None:
            throttle.get(1)
        attrs, omap = self._gather_push_meta(oid)

        def on_data(data):
            if throttle is not None:
                throttle.put(1)
            if data is None:
                # reconstruction failed (mid-churn shortage): retry
                # while the peer still owes this object, or its
                # peer_missing entry never clears and reads avoid the
                # shard forever. Bounded + deduped: one retry chain per
                # (oid, peer), backing off, giving up after ~2 minutes
                # (a later peer re-report or peering round re-arms)
                key = (oid, peer_osd)
                with self.lock:
                    if key in self._push_retrying:
                        return
                    self._push_retrying.add(key)
                delay = 1.0 if attempt < 10 else 3.0
                if attempt < 40:
                    self.daemon.timer.add_event_after(
                        delay, self._retry_push, oid, shard, peer_osd,
                        attempt + 1, lane)
                else:
                    with self.lock:
                        self._push_retrying.discard(key)
                return
            # log-domain version: a replica's missing entry records the
            # LOG version of the entry that created the object; a snap
            # clone's VERSION_ATTR is the pre-capture head version
            # (deliberately older), so pushing the attr version alone
            # would never satisfy the replica's missing gate
            version = max(int(attrs.get(VERSION_ATTR, b"0") or 0),
                          self._log_version_of(oid))
            self._count_push(lane, len(data))
            msg = MOSDPGPush(
                pgid=self.pgid, from_osd=self.whoami, shard=shard,
                oid=oid, data=data, attrs=attrs, omap=omap,
                version=version, map_epoch=self.map_epoch(),
                force=force)
            if peer_osd == self.whoami:
                self.handle_push(msg)
            else:
                self.send_to_osd(peer_osd, msg)

        self.backend.recover_object(oid, shard, on_data)

    def _count_push(self, lane: str, nbytes: int) -> None:
        """l_osd_recovery_*/l_osd_backfill_* accounting, per completed
        push (best-effort: scrub harnesses run PGs against daemon
        stubs without the full counter set)."""
        perf = getattr(self.daemon, "perf", None)
        if perf is None:
            return
        try:
            perf.inc("l_osd_%s_ops" % lane)
            perf.inc("l_osd_%s_bytes" % lane, nbytes)
        except KeyError:
            pass

    def _log_version_of(self, oid) -> int:
        """Latest log version touching oid (0 when not in the log)."""
        with self.lock:
            for e in reversed(self.pg_log.entries):
                if e.oid == oid:
                    return e.version
        return 0

    def _retry_push(self, oid, shard: int, peer_osd: int,
                    attempt: int = 1, lane: str = "recovery") -> None:
        with self.lock:
            self._push_retrying.discard((oid, peer_osd))
            if self.acting_primary != self.whoami or \
                    (oid not in self.peer_missing
                     and oid not in self.backfilling):
                return
        self._push_object(oid, shard, peer_osd, attempt=attempt,
                          lane=lane)

    # -- recovery/backfill reservations --------------------------------

    def _reservers(self):
        """The daemon's four AsyncReservers, or None on the stub
        daemons scrub/unit harnesses run PGs against — a None here
        turns the whole reservation machinery into a pass-through."""
        return getattr(self.daemon, "reservations", None)

    def _holds_reservation(self, lane: str) -> bool:
        if self._reservers() is None:
            return True
        with self.lock:
            return self._resv_state[lane] == "granted"

    def _request_reservations(self, lane: str) -> None:
        """Start the reservation round: queue for the LOCAL slot; the
        grant callback fans out to the replicas' remote slots."""
        reservers = self._reservers()
        if reservers is None:
            return
        with self.lock:
            if self._resv_state[lane] not in ("idle", "toofull"):
                return            # a round is already in flight
            self._resv_state[lane] = "local_wait"
            interval = self.interval
        reservers["local_" + lane].request_reservation(
            (str(self.pgid), lane),
            lambda: self._local_reservation_granted(lane, interval),
            _RESV_PRIO[lane],
            on_preempt=lambda: self._reservation_preempted(
                lane, interval))

    def _local_reservation_granted(self, lane: str,
                                   interval: int) -> None:
        peers = None
        with self.lock:
            if interval == self.interval \
                    and self._resv_state[lane] == "local_wait":
                peers = {o for o in set(self.acting) | set(self.up)
                         if o != self.whoami and o != CRUSH_ITEM_NONE}
                self._resv_want[lane] = set(peers)
                self._resv_have[lane] = set()
                self._resv_state[lane] = ("remote_wait" if peers
                                          else "granted")
        if peers is None:
            # the interval moved while we queued: give the slot back
            self._reservers()["local_" + lane].cancel_reservation(
                (str(self.pgid), lane))
            return
        if not peers:
            self._drain_reserved_pushes(lane)
            return
        for osd in peers:
            self.send_to_osd(osd, MBackfillReserve(
                pgid=self.pgid, from_osd=self.whoami, lane=lane,
                op="request", priority=_RESV_PRIO[lane],
                map_epoch=self.map_epoch()))

    def _reservation_preempted(self, lane: str, interval: int) -> None:
        """A higher-priority PG evicted our LOCAL slot: back out of the
        whole round (remote holds included) and re-queue behind it."""
        self._release_reservation(lane, keep_pending=True)
        self._schedule_resv_retry(lane, 0.5)

    def handle_reserve(self, msg) -> None:
        """MBackfillReserve dispatch: request/release land on the
        replica role, grant/reject on the requesting primary."""
        lane = msg.lane
        if msg.op == "request":
            self._handle_reserve_request(msg)
        elif msg.op == "release":
            reservers = self._reservers()
            if reservers is not None:
                reservers["remote_" + lane].cancel_reservation(
                    (str(self.pgid), lane, msg.from_osd))
            with self.lock:
                self._resv_remote_keys.discard((lane, msg.from_osd))
        else:                      # grant | reject
            self._handle_reserve_reply(msg)

    def _handle_reserve_request(self, msg) -> None:
        lane = msg.lane

        def answer(op, reason=""):
            self.send_to_osd(msg.from_osd, MBackfillReserve(
                pgid=self.pgid, from_osd=self.whoami, lane=lane,
                op=op, priority=msg.priority,
                map_epoch=self.map_epoch(), reason=reason))

        # fullness veto BEFORE slot accounting: a backfillfull replica
        # refuses backfill outright, a full one refuses recovery — the
        # primary parks in *_toofull and retries after the drain
        check = getattr(self.daemon, "reserve_refusal", None)
        refusal = check(lane) if check is not None else None
        if refusal:
            answer("reject", refusal)
            return
        reservers = self._reservers()
        if reservers is None:
            answer("grant")
            return
        with self.lock:
            self._resv_remote_keys.add((lane, msg.from_osd))
        reservers["remote_" + lane].request_reservation(
            (str(self.pgid), lane, msg.from_osd),
            lambda: answer("grant"), msg.priority,
            on_preempt=lambda: answer("reject", "preempted"))

    def _handle_reserve_reply(self, msg) -> None:
        lane = msg.lane
        granted = False
        with self.lock:
            if self._resv_state[lane] != "remote_wait":
                return             # stale reply from a released round
            if msg.op == "grant":
                self._resv_have[lane].add(msg.from_osd)
                granted = self._resv_have[lane] >= \
                    self._resv_want[lane]
                if granted:
                    self._resv_state[lane] = "granted"
        if msg.op == "grant":
            if granted:
                self._drain_reserved_pushes(lane)
            return
        # reject: back out completely so the replicas that DID grant
        # are not pinned behind us, then park — toofull waits for the
        # replica to drain, a preempted/busy one retries sooner
        toofull = getattr(msg, "reason", "") == "toofull"
        self._release_reservation(
            lane, keep_pending=True,
            parked="toofull" if toofull else "idle")
        self._schedule_resv_retry(lane, 5.0 if toofull else 1.0)

    def _drain_reserved_pushes(self, lane: str) -> None:
        """Every slot is held: the parked pushes enter the op queue —
        RECOVERY class, so dmclock keeps client ops at their share."""
        with self.lock:
            pending = self._resv_pending[lane]
            self._resv_pending[lane] = []
        wq = getattr(self.daemon, "op_wq", None)
        prio = getattr(self.daemon, "recovery_op_priority", 10)
        for oid, shard, peer, attempt in pending:
            if wq is not None:
                wq.queue(self.pgid, self._push_object, oid, shard,
                         peer, False, attempt, lane,
                         klass="recovery", priority=prio)
            else:
                self._push_object(oid, shard, peer, False, attempt,
                                  lane)

    def _release_reservation(self, lane: str, keep_pending=False,
                             parked: str = "idle") -> None:
        """Drop the local slot and every remote hold/request for this
        lane (completion, rejection backout, preemption, interval
        change — every exit from the round goes through here)."""
        reservers = self._reservers()
        if reservers is None:
            return
        with self.lock:
            state = self._resv_state[lane]
            self._resv_state[lane] = parked
            want, self._resv_want[lane] = self._resv_want[lane], set()
            self._resv_have[lane] = set()
            if not keep_pending:
                self._resv_pending[lane] = []
        if state in ("local_wait", "remote_wait", "granted"):
            reservers["local_" + lane].cancel_reservation(
                (str(self.pgid), lane))
            for osd in want:
                self.send_to_osd(osd, MBackfillReserve(
                    pgid=self.pgid, from_osd=self.whoami, lane=lane,
                    op="release", map_epoch=self.map_epoch()))

    def _release_reservations(self) -> None:
        """Interval change: both primary-side rounds restart and every
        remote slot we granted a (possibly gone) primary is freed."""
        self._release_peering_slot()
        for lane in ("recovery", "backfill"):
            self._release_reservation(lane)
        reservers = self._reservers()
        if reservers is None:
            return
        with self.lock:
            remote, self._resv_remote_keys = \
                self._resv_remote_keys, set()
        for lane, primary in remote:
            reservers["remote_" + lane].cancel_reservation(
                (str(self.pgid), lane, primary))

    def _maybe_release_reservations(self) -> None:
        """Completion detection: a drained lane (no peer owes objects,
        nothing parked) gives its slots back immediately — holding a
        backfill slot through an idle period starves other PGs."""
        if self._reservers() is None:
            return
        with self.lock:
            rec = (self._resv_state["recovery"] != "idle"
                   and not self.peer_missing
                   and not self._resv_pending["recovery"])
            bf = (self._resv_state["backfill"] != "idle"
                  and not self.backfilling
                  and not self._resv_pending["backfill"])
        if rec:
            self._release_reservation("recovery")
        if bf:
            self._release_reservation("backfill")

    def _schedule_resv_retry(self, lane: str, delay: float) -> None:
        with self.lock:
            interval = self.interval
        timer = getattr(self.daemon, "timer", None)
        if timer is not None:
            timer.add_event_after(delay, self._resv_retry, lane,
                                  interval)

    def _resv_retry(self, lane: str, interval: int) -> None:
        with self.lock:
            if interval != self.interval \
                    or self.acting_primary != self.whoami:
                return
            if self._resv_state[lane] not in ("idle", "toofull"):
                return
            has_work = bool(self._resv_pending[lane])
        if has_work:
            # _request_reservations re-enters from idle/toofull
            with self.lock:
                self._resv_state[lane] = "idle"
            self._request_reservations(lane)

    def handle_push(self, msg) -> None:
        """Apply a recovery push to the local shard store."""
        cid = self.cid_of_shard(
            msg.shard if self.pool.is_erasure() else -1)
        # the push rewrites the hinfo xattr behind the EC backend's
        # cache: drop the cached entry or size/crc queries serve the
        # pre-recovery state
        if self.pool.is_erasure():
            self.backend.hinfo_cache.pop(msg.oid, None)
        # never let an in-flight push of an older version clobber a
        # fresher local copy (an acked client write may have landed
        # while the push was in transit)
        try:
            raw = self.store.getattr(cid, msg.oid, VERSION_ATTR)
            local_v = int(raw) if raw else 0
        except KeyError:
            local_v = -1
        # only a strictly newer push may replace an existing copy; a
        # versionless push (source object vanished mid-recovery) must
        # never clobber versioned local data
        self._pulling.pop(msg.oid, None)
        waiters = []
        with self.lock:
            if self.missing.get(msg.oid, 0) <= msg.version:
                self.missing.pop(msg.oid, None)
                self._missing_src.pop(msg.oid, None)
                waiters = self._missing_waiters.pop(msg.oid, [])
        def ack_recovered():
            # tell the primary this shard is consistent again so its
            # peer_missing map stops steering reads around us
            if msg.from_osd == self.whoami:
                with self.lock:
                    peers = self.peer_missing.get(msg.oid)
                    if peers is not None:
                        peers.discard(self.whoami)
                        if not peers:
                            self.peer_missing.pop(msg.oid, None)
                    backf = self.backfilling.get(msg.oid)
                    if backf is not None:
                        backf.discard(self.whoami)
                        if not backf:
                            self.backfilling.pop(msg.oid, None)
                self._maybe_release_reservations()
            else:
                self.send_to_osd(msg.from_osd, MOSDPGNotify(
                    pgid=self.pgid, from_osd=self.whoami,
                    missing=[msg.oid], kind="recovered",
                    map_epoch=self.map_epoch()))

        try:
            if msg.delete:
                # divergent-delete propagation: drop our ghost copy
                # unless we hold a strictly newer (recreated) version —
                # and record the delete so that if WE later become
                # primary we can propagate it instead of pulling the
                # ghost back
                with self.lock:
                    if msg.version > self._deleted_log.get(msg.oid, -1):
                        self._deleted_log.pop(msg.oid, None)
                        self._deleted_log[msg.oid] = msg.version
                if local_v >= 0 and local_v <= msg.version:
                    txn = Transaction()
                    txn.remove(cid, msg.oid)
                    txn.register_on_commit(ack_recovered)
                    self.store.queue_transaction(txn)
                else:
                    ack_recovered()
                return
            # scrub repairs (force) may overwrite SAME-version bitrot;
            # no push — forced or not — may ever roll back a strictly
            # newer (acked) local copy
            if local_v >= 0 and (local_v > msg.version
                                 or (local_v == msg.version
                                     and not msg.force)):
                ack_recovered()   # our copy is already current
                return
            txn = Transaction()
            txn.remove(cid, msg.oid)
            txn.touch(cid, msg.oid)
            if msg.data:
                txn.write(cid, msg.oid, 0, msg.data)
            for name, val in msg.attrs.items():
                txn.setattr(cid, msg.oid, name, val)
            if msg.omap:
                txn.omap_setkeys(cid, msg.oid, msg.omap)
            txn.register_on_commit(ack_recovered)
            self.store.queue_transaction(txn)
        finally:
            # the recovered object unblocks any ops held on it: each
            # runs, and the first error one raised is raised after all
            failure = None
            for fn in waiters:
                try:
                    fn()
                except Exception as e:
                    if failure is None:
                        failure = e
            if failure is not None:
                raise failure
