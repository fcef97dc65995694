"""Replicated PG backend.

Port of ``ceph_tpu/osd/replicated_backend.py``, host code the port keeps
its own copy of: the PG's backend for a replicated pool.

Role of the reference's ReplicatedBackend (src/osd/ReplicatedBackend.cc):
the primary applies the logical transaction locally, fans MOSDRepOp with
the physical ops to every replica, and completes the client op when all
acting replicas commit. Reads are local to the primary. Recovery is
push-based: the primary sends the whole object state.
"""

from __future__ import annotations

import itertools
import threading

from ..common.bounded import BoundedDict
from ..common.lockdep import make_rlock
from ..common.tracer import NULL_SPAN, trace_ctx
from ..msg.message import MOSDRepOp, MOSDRepOpReply
from ..store.object_store import Transaction

__all__ = ["ReplicatedBackend"]


class _Inflight:
    def __init__(self, tid, on_commit, waiting_on):
        self.tid = tid
        self.on_commit = on_commit
        self.waiting_on = set(waiting_on)
        self.msg = None               # the MOSDRepOp, for retransmit
        self.sub_spans: dict = {}     # osd -> per-peer rep-op span


class ReplicatedBackend:
    # sub-ops are at-least-once: fan-out retries ride the timer until
    # every peer acks (a dropped MOSDRepOp must not wedge the write),
    # and replicas dedup by (from_osd, tid) so retransmits replay the
    # ack without re-applying the transaction
    RETRY_INTERVAL = 1.0

    def __init__(self, pg):
        self.pg = pg
        self._tids = itertools.count(1)
        self.lock = make_rlock("rep-backend:%s" % (pg.pgid,))
        self.inflight: dict[int, _Inflight] = {}
        # per-instance nonce: tids restart when a daemon restarts, so
        # the replica dedup keys on (instance, tid) — a reborn primary
        # must never hit a dead incarnation's cache entries
        import uuid
        self.instance = uuid.uuid4().hex
        self._seen: BoundedDict = BoundedDict()  # key -> committed?

    # -- write ---------------------------------------------------------

    def submit_transaction(self, pg_txn, at_version: int,
                           on_commit, reqid: tuple = ("", 0),
                           trace=NULL_SPAN) -> int:
        tid = next(self._tids)
        if trace is None:
            trace = NULL_SPAN
        txn = self._physical_txn(pg_txn)
        peers = [o for o in self.pg.acting_osds() if o >= 0]
        log_entries = self.pg.mint_log_entries(pg_txn.op_map, at_version,
                                               reqid)
        op = _Inflight(tid, on_commit, peers)
        t_id, p_id = trace_ctx(trace)
        op.msg = MOSDRepOp(pgid=self.pg.pgid, from_osd=self.pg.whoami,
                           tid=tid, at_version=at_version,
                           log_entries=log_entries, txn_ops=txn.ops,
                           map_epoch=self.pg.map_epoch(),
                           instance=self.instance, trace_id=t_id,
                           parent_span=p_id)
        with self.lock:
            self.inflight[tid] = op
            for osd in peers:
                span = trace.child("rep_op(osd=%d)" % osd)
                op.sub_spans[osd] = span
        for osd in peers:
            if osd == self.pg.whoami:
                self.handle_rep_op(op.msg, local=True)
            else:
                self.pg.send_to_osd(osd, op.msg)
        self.pg.daemon.timer.add_event_after(
            self.RETRY_INTERVAL, self._retry_inflight, tid)
        return tid

    def _retry_inflight(self, tid: int) -> None:
        acting = set(self.pg.acting_osds())
        done = None
        with self.lock:
            op = self.inflight.get(tid)
            if op is None:
                return                 # completed
            # a peer that left the acting set can never ack: stop
            # waiting on it (the new interval's peering roll-forward
            # owns its convergence) — otherwise a dead replica wedges
            # the write forever while duplicates are being dropped
            op.waiting_on &= acting | {self.pg.whoami}
            if not op.waiting_on:
                self.inflight.pop(tid, None)
                done = op
            waiting = set(op.waiting_on)
            msg = op.msg
        if done is not None:
            for span in done.sub_spans.values():
                span.finish()
            done.sub_spans = {}
            if done.on_commit:
                done.on_commit()
            return
        for osd in waiting:
            if osd != self.pg.whoami:
                self.pg.send_to_osd(osd, msg)
        self.pg.daemon.timer.add_event_after(
            self.RETRY_INTERVAL, self._retry_inflight, tid)

    def _physical_txn(self, pg_txn) -> Transaction:
        """Logical -> physical is 1:1 for replication (no striping)."""
        cid = self.pg.cid_of_shard(-1)
        txn = Transaction()
        for oid, op in pg_txn.safe_create_traverse():
            if op.deletes_first():
                txn.remove(cid, oid)
            if op.init_type == "create":
                txn.touch(cid, oid)
            elif op.init_type == "clone":
                txn.clone(cid, op.source, oid)
            elif op.init_type == "rename":
                txn.collection_move_rename(cid, op.source, cid, oid)
            if op.truncate is not None:
                txn.truncate(cid, oid, op.truncate[0])
            for upd in op.buffer_updates:
                if upd[0] == "write":
                    txn.write(cid, oid, upd[1], upd[2])
                else:
                    txn.zero(cid, oid, upd[1], upd[2])
            if op.truncate is not None and \
                    op.truncate[1] != op.truncate[0]:
                txn.truncate(cid, oid, op.truncate[1])
            for name, value in op.attr_updates.items():
                if value is None:
                    txn.rmattr(cid, oid, name)
                else:
                    txn.setattr(cid, oid, name, value)
            if op.omap_updates:
                txn.omap_setkeys(cid, oid, op.omap_updates)
            if op.omap_rmkeys:
                txn.omap_rmkeys(cid, oid, op.omap_rmkeys)
        return txn

    # -- replica -------------------------------------------------------

    def handle_rep_op(self, msg, local: bool = False) -> None:
        def on_commit():
            reply = MOSDRepOpReply(pgid=self.pg.pgid,
                                   from_osd=self.pg.whoami,
                                   tid=msg.tid, committed=True)
            if local:
                self.handle_rep_op_reply(reply)
            else:
                self.pg.send_to_osd(msg.from_osd, reply)

        # retransmit? replay the ack — but only once the ORIGINAL
        # application actually committed (acking uncommitted data
        # would let the primary complete a write a crashing replica
        # never made durable); an uncommitted in-flight original just
        # drops the duplicate (its own commit will ack)
        key = (getattr(msg, "instance", "") or msg.from_osd, msg.tid)
        with self.lock:
            state = self._seen.get(key)
            if state is None:
                self._seen[key] = False     # received, not committed
        if state is not None:
            if state:
                on_commit()
            return

        # replica-side span, stitched from the envelope context
        span = self.pg.daemon.tracer.continue_trace(
            "rep_apply", getattr(msg, "trace_id", 0),
            getattr(msg, "parent_span", 0))
        span.keyval("tid", msg.tid)

        def commit_and_ack():
            with self.lock:
                self._seen[key] = True
            span.finish()
            on_commit()

        txn = Transaction()
        txn.ops = list(msg.txn_ops)
        txn.trace = span             # store-level spans nest under it
        # log keys ride the same store transaction as the data
        self.pg.log_operation(msg.log_entries, msg.at_version, -1,
                              txn=txn)
        txn.register_on_commit(commit_and_ack)
        self.pg.store.queue_transaction(txn)

    def handle_rep_op_reply(self, msg) -> None:
        with self.lock:
            op = self.inflight.get(msg.tid)
            if op is None:
                return
            op.waiting_on.discard(msg.from_osd)
            span = op.sub_spans.pop(msg.from_osd, None)
            if op.waiting_on:
                if span is not None:
                    span.finish()
                return
            self.inflight.pop(msg.tid, None)
            leftovers = list(op.sub_spans.values())
            op.sub_spans = {}
        if span is not None:
            span.finish()
        for s in leftovers:
            s.finish()
        if op.on_commit:
            op.on_commit()

    # -- read ----------------------------------------------------------

    def objects_read(self, oid, off: int, length: int, on_done,
                     trace=NULL_SPAN) -> None:
        if trace is None:
            trace = NULL_SPAN
        try:
            with trace.child("local_read"):
                data = self.pg.local_read_shard(-1, oid, off, length)
        except (OSError, KeyError):
            on_done(None)
            return
        on_done(data)

    # -- recovery ------------------------------------------------------

    def recover_object(self, oid, target_shard: int, on_done) -> None:
        """Full-copy push source: the primary's bytes ARE the object."""
        try:
            data = self.pg.local_read_shard(-1, oid, 0, 0)
        except (OSError, KeyError):
            on_done(None)
            return
        on_done(data)
