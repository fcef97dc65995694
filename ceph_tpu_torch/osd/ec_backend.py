"""Erasure-coded PG backend: the two-phase write/read/recovery pipeline.

Role of the reference's ECBackend (src/osd/ECBackend.{h,cc}):

  write   submit_transaction (:1437) -> start_rmw plans the op (:1756)
          -> the op walks three wait queues — waiting_state (needs
          readback?), waiting_reads (readback in flight), waiting_commit
          (sub-writes in flight) — advanced by try_state_to_reads
          (:1782), try_reads_to_commit (:1857, where ECTransaction
          generates per-shard transactions and MOSDECSubOpWrite fans
          out :1989), try_finish_rmw (:2017). The local shard
          self-delivers (:1998). All-shards-commit completes the op.
  replica handle_sub_write (:917): apply the shard transaction, ack
          with sub_write_committed (:840).
  read    objects_read_and_reconstruct (:2258): pick min shards via
          minimum_to_decode (:1488-1556), sub-read chunk extents
          (handle_sub_read :982 on each shard), reassemble/decode on
          reply (:1115), complete in order.
  recovery  reconstruct a lost shard from k survivors and push it
          (continue_recovery_op :531 reshaped into the PG's recovery
          drive).

Encode/decode of whole multi-stripe extents happen as single batched
device calls through ec_util; the per-op pipeline itself is plain host
orchestration.

Port of ``ceph_tpu/osd/ec_backend.py``. The pipelines, their queues,
locks, messages and fallbacks are the reference's; where the port
differs:

* The daemon's dispatcher is ``daemon.gpu_dispatcher``
  (``osd/gpu_dispatch.GpuDispatcher``), where the reference reads
  ``tpu_dispatcher`` (:236, :760, :991, :1080).
* The resident rebuild of a sub-symbol codec
  (``_tier_reconstruct_striped``, the reference's one JAX code, :588-608)
  stays on the tier's device: the resident ``[n, S*chunk]`` tensor viewed
  as ``[S, n, chunk]``, the k survivor rows taken with ``index_select``
  there, ``codec.decode_batch`` on that device tensor, and only the
  rebuilt row copied to the host.
* A resident read (``_tier_read``) copies only the k data rows off the
  device, where the reference's ``np.asarray`` of the whole tensor
  (:525) would raise on a CUDA tensor.
* The tier paths fall through to the sub-read path only on a miss:
  ``tier.get`` returning None, the tier's ``KeyError``, or the shape
  drift they name (a stream not chunk aligned, a rebuilt or resident
  length that does not match). Any other error propagates, where the
  reference's ``except Exception`` (:548, :581) would send every
  resident read and rebuild down the sub-read path and hide a fault of
  the card.
* The device legs of recovery and repair fall back only on what the
  reference means as a miss, and let any other error (a failed launch
  or build on the card) propagate: the cross-chip rebuild and repair
  (:871, :1072) on the mesh's ``MeshChecksumError`` or the codec's
  ``ErasureCodeError``, the combine (:1081) on the ``ErasureCodeError``
  of fractions that do not fit, and a helper's fraction (:995) on a
  read error (``OSError``, ``KeyError``) or that ``ErasureCodeError``,
  which become its errno reply. The reference catches every exception
  in all four.
"""

from __future__ import annotations

import itertools
import json
import threading

import numpy as np
import torch

from ..common.bounded import BoundedDict
from ..common.interval_set import IntervalSet
from ..common.lockdep import make_rlock
from ..common.tracer import NULL_SPAN, trace_ctx
from ..crush.map import CRUSH_ITEM_NONE
from ..errors import ErasureCodeError
from ..msg.message import (MOSDECSubOpRead, MOSDECSubOpReadReply,
                           MOSDECSubOpRepairRead,
                           MOSDECSubOpRepairReadReply,
                           MOSDECSubOpWrite, MOSDECSubOpWriteReply)
from ..parallel.mesh import MeshChecksumError
from ..store.object_store import Transaction
from . import ec_transaction, ec_util
from .extent_cache import ExtentCache

__all__ = ["ECBackend"]


class _TierMiss(Exception):
    """A resident entry whose shape no longer matches the object (the
    reference's "shape drift"): the tier paths treat it as a miss."""


class _InflightWrite:
    def __init__(self, tid, pg_txn, at_version, on_commit,
                 trace=NULL_SPAN):
        self.tid = tid
        self.pg_txn = pg_txn
        self.at_version = at_version
        self.on_commit = on_commit
        self.trace = trace            # the client op's span (or null)
        self.sub_spans: dict = {}     # shard -> per-shard sub-write span
        self.plan = None
        self.pin = None
        self.must_read: dict = {}     # oid -> IntervalSet
        self.remote_read_result: dict = {}  # oid -> ExtentMap
        self.pending_reads = 0
        self.pending_commits: set = set()   # shard ids
        self.state = "state"          # state -> reads -> commit -> done


class _InflightRead:
    def __init__(self, tid, oid, off, length, on_done,
                 trace=NULL_SPAN):
        self.tid = tid
        self.oid = oid
        self.off = off
        self.length = length
        self.on_done = on_done
        self.trace = trace
        self.sub_spans: dict = {}     # shard -> per-shard sub-read span
        self.raw_shards_cb = None     # recovery: wants raw shard streams
        self.shard_data: dict = {}    # shard -> bytes
        self.want_shards: set = set()
        self.chunk_off = 0
        self.chunk_len = 0
        self.errors: dict = {}


class _InflightRepair:
    """One regenerating-code rebuild: d helper fraction reads in
    flight, with helper substitution on error and an ordered fallback
    to the full-survivor decode."""

    def __init__(self, tid, oid, target_shard, chunk_total, on_done,
                 fallback):
        self.tid = tid
        self.oid = oid
        self.target_shard = target_shard
        self.chunk_total = chunk_total
        self.on_done = on_done
        self.fallback = fallback      # () -> None: survivor decode
        self.helpers: set = set()     # current helper set (d shards)
        self.tried: set = set()       # every helper ever asked
        self.fractions: dict = {}     # shard -> fraction bytes


class ECBackend:
    def __init__(self, pg, codec, stripe_width: int):
        self.pg = pg                  # owning PG (listener interface)
        self.codec = codec
        self.sinfo = ec_util.StripeInfo(codec.get_data_chunk_count(),
                                        stripe_width)
        self.cache = ExtentCache()
        self._tids = itertools.count(1)
        self.lock = make_rlock("ec-backend:%s" % (pg.pgid,))
        # the three wait queues (ECBackend.h:561-563)
        self.waiting_state: list[_InflightWrite] = []
        self.waiting_reads: list[_InflightWrite] = []
        self.waiting_commit: list[_InflightWrite] = []
        self.inflight_reads: dict = {}
        self.inflight_repairs: dict = {}
        self.hinfo_cache: dict = {}
        import uuid
        self.instance = uuid.uuid4().hex  # incarnation nonce (dedup)
        self._sub_seen: BoundedDict = BoundedDict()  # key -> committed?

    # -- geometry ------------------------------------------------------

    @property
    def k(self) -> int:
        return self.codec.get_data_chunk_count()

    @property
    def n(self) -> int:
        return self.codec.get_chunk_count()

    def get_hinfo(self, oid) -> ec_util.HashInfo:
        h = self.hinfo_cache.get(oid)
        if h is None:
            raw = self.pg.local_getattr(oid, ec_transaction.HINFO_KEY)
            if raw is not None:
                h = ec_util.HashInfo.from_dict(json.loads(
                    raw.decode() if isinstance(raw, bytes) else raw))
            else:
                h = ec_util.HashInfo(self.n)
            self.hinfo_cache[oid] = h
        return h

    # =================================================================
    # write pipeline (primary)
    # =================================================================

    def submit_transaction(self, pg_txn, at_version: int,
                           on_commit, reqid: tuple = ("", 0),
                           trace=NULL_SPAN) -> int:
        tid = next(self._tids)
        op = _InflightWrite(tid, pg_txn, at_version, on_commit,
                            trace=trace if trace is not None
                            else NULL_SPAN)
        op.reqid = reqid
        with self.lock:
            self.waiting_state.append(op)
        self.check_ops()
        return tid

    def check_ops(self) -> None:
        """Advance every queue as far as possible (check_ops :2065)."""
        while self._try_state_to_reads():
            pass
        while self._try_reads_to_commit():
            pass

    def _try_state_to_reads(self) -> bool:
        with self.lock:
            if not self.waiting_state:
                return False
            op = self.waiting_state[0]
            op.plan = ec_transaction.get_write_plan(
                self.sinfo, op.pg_txn, self.get_hinfo)
            op.pin = self.cache.open_write_pin(op.tid)
            must_read_total = 0
            for oid, to_read in op.plan.to_read.items():
                will_write = op.plan.will_write.get(oid) or IntervalSet()
                must = self.cache.reserve_extents_for_rmw(
                    oid, op.pin, to_read, will_write)
                if must:
                    op.must_read[oid] = must
                    must_read_total += 1
            for oid in op.plan.will_write:
                if oid not in op.plan.to_read:
                    self.cache.reserve_extents_for_rmw(
                        oid, op.pin, IntervalSet(),
                        op.plan.will_write[oid])
            self.waiting_state.pop(0)
            op.state = "reads"
            self.waiting_reads.append(op)
            launch = dict(op.must_read)
        # launch RMW readbacks outside the lock
        for oid, must in launch.items():
            for off, length in must:
                op.pending_reads += 1
                self._start_read(oid, off, length,
                                 lambda data, o=op, i=oid, f=off:
                                 self._rmw_read_done(o, i, f, data),
                                 internal=True)
        return True

    def _rmw_read_done(self, op, oid, off, data) -> None:
        with self.lock:
            if data is not None:
                self.cache.present_read(oid, off, data)
            op.pending_reads -= 1
        self.check_ops()

    def _try_reads_to_commit(self) -> bool:
        with self.lock:
            if not self.waiting_reads:
                return False
            op = self.waiting_reads[0]
            if op.pending_reads > 0:
                return False
            self.waiting_reads.pop(0)
            op.state = "commit"
            # collect cached extents for the planner
            partial = {}
            for oid, to_read in op.plan.to_read.items():
                partial[oid] = self.cache.get_remaining_extents_for_rmw(
                    oid, to_read)
            shards = self.pg.acting_shards()     # shard -> osd (may hole)
            # encode under its own span so the dispatcher's gpu_queue /
            # gpu_device segments nest beneath it (ECBackend.cc:1857's
            # try_reads_to_commit is where the codec runs)
            enc_span = op.trace.child("ec_encode")
            txns, written = ec_transaction.generate_transactions(
                op.plan, self.codec, self.sinfo, partial,
                list(range(self.n)), self.pg.cid_of_shard,
                dispatcher=getattr(self.pg.daemon, "gpu_dispatcher",
                                   None),
                trace=enc_span,
                # whole-object encodes stay device-resident keyed by
                # (pg, oid): scrub/recovery (and opt-in repeat reads)
                # then never re-cross the host-device pipe
                tier=getattr(self.pg.daemon, "hbm_tier", None),
                tier_prefix=str(self.pg.pgid),
                # fused write transform config (osd_fused_transform /
                # osd_fused_compression_mode options via the daemon)
                fused_mode=getattr(self.pg.daemon, "fused_mode", None),
                fused_required_ratio=getattr(
                    self.pg.daemon, "fused_required_ratio", 0.875),
                fused_entropy_max=getattr(
                    self.pg.daemon, "fused_entropy_max", 7.0))
            enc_span.finish()
            for oid, wmap in written.items():
                self.cache.present_rmw_update(oid, wmap)
            op.pending_commits = {s for s, osd in shards.items()
                                  if osd != CRUSH_ITEM_NONE}
            self.waiting_commit.append(op)
            log_entry = self.pg.mint_log_entries(
                op.plan.t.op_map, op.at_version,
                getattr(op, "reqid", ("", 0)))
        op.sub_msgs = {}
        for shard, osd in shards.items():
            if osd == CRUSH_ITEM_NONE:
                continue
            # one child span per shard sub-write (ECBackend.cc:1978-83)
            sub_span = op.trace.child("sub_write(shard=%d)" % shard)
            sub_span.keyval("osd", osd)
            op.sub_spans[shard] = sub_span
            t_id, p_id = trace_ctx(sub_span)
            msg = MOSDECSubOpWrite(
                pgid=self.pg.pgid, shard=shard, from_osd=self.pg.whoami,
                tid=op.tid, at_version=op.at_version,
                log_entries=log_entry,
                txn_ops=txns[shard].ops, map_epoch=self.pg.map_epoch(),
                instance=self.instance, trace_id=t_id,
                parent_span=p_id)
            op.sub_msgs[shard] = (osd, msg)
            if osd == self.pg.whoami:
                self.handle_sub_write(msg, local=True)
            else:
                self.pg.send_to_osd(osd, msg)
        # at-least-once: re-fan-out to unacked shards until done (a
        # dropped sub-op must not wedge the write; replicas dedup)
        self.pg.daemon.timer.add_event_after(
            1.0, self._retry_sub_writes, op.tid)
        return True

    def _retry_sub_writes(self, tid: int) -> None:
        shards_now = self.pg.acting_shards()
        target = None
        with self.lock:
            op = next((o for o in self.waiting_commit
                       if o.tid == tid), None)
            if op is None:
                return                 # completed
            msgs = dict(getattr(op, "sub_msgs", {}))
            # shards whose OSD left the acting set can never ack:
            # stop waiting (peering roll-forward owns them now)
            for shard in list(op.pending_commits):
                osd, _ = msgs.get(shard, (None, None))
                if osd is None or shards_now.get(shard) != osd:
                    op.pending_commits.discard(shard)
            pending = set(op.pending_commits)
            if not pending:
                target = op
        if target is not None:
            self._try_finish_rmw(target)
            return
        for shard in pending:
            osd, msg = msgs.get(shard, (None, None))
            if msg is not None and osd != self.pg.whoami:
                self.pg.send_to_osd(osd, msg)
        self.pg.daemon.timer.add_event_after(
            1.0, self._retry_sub_writes, tid)

    def _try_finish_rmw(self, op) -> None:
        with self.lock:
            if op.pending_commits:
                return
            if op in self.waiting_commit:
                self.waiting_commit.remove(op)
            self.cache.release_write_pin(op.pin)
            on_commit = op.on_commit
            spans = list(op.sub_spans.values())
            op.sub_spans = {}
        for span in spans:   # shards dropped mid-interval finish here
            span.finish()
        if on_commit:
            on_commit()
        self.check_ops()

    # -- replica side --------------------------------------------------

    def handle_sub_write(self, msg, local: bool = False) -> None:
        """Apply a shard transaction + log, then ack (:917-979).
        Retransmits (the primary's at-least-once fan-out) replay the
        ack without re-applying."""
        key = (getattr(msg, "instance", "") or msg.from_osd,
               msg.tid, msg.shard)
        with self.lock:
            state = self._sub_seen.get(key)
            if state is None:
                self._sub_seen[key] = False   # received, uncommitted
        if state is not None:
            # replay the ack only for a COMMITTED original; an
            # in-flight one acks by itself when its commit lands
            if state:
                reply = MOSDECSubOpWriteReply(
                    pgid=self.pg.pgid, shard=msg.shard,
                    from_osd=self.pg.whoami, tid=msg.tid,
                    committed=True, applied=True)
                if local:
                    self.handle_sub_write_reply(reply)
                else:
                    self.pg.send_to_osd(msg.from_osd, reply)
            return
        # replica-side span, stitched under the primary's per-shard
        # child via the envelope context (covers store apply + commit)
        span = self.pg.daemon.tracer.continue_trace(
            "ec_sub_write", getattr(msg, "trace_id", 0),
            getattr(msg, "parent_span", 0))
        span.keyval("shard", msg.shard)
        span.keyval("tid", msg.tid)
        txn = Transaction()
        txn.ops = list(msg.txn_ops)
        txn.trace = span             # store-level spans nest under it
        # log keys ride the same store transaction as the shard data
        self.pg.log_operation(msg.log_entries, msg.at_version,
                              msg.shard, txn=txn)
        done = threading.Event()
        # the shard txn rewrites hinfo xattrs BEHIND the cache: a
        # replica whose cache kept a pre-write (empty) entry would,
        # on becoming primary, serve a stale size — which turns a
        # snapshot-capture write into a silent no-capture
        touched = {op[2] for op in msg.txn_ops
                   if len(op) > 2 and isinstance(op[2], str)}

        def on_commit():
            with self.lock:
                self._sub_seen[key] = True
                for oid in touched:
                    self.hinfo_cache.pop(oid, None)
            span.finish()
            reply = MOSDECSubOpWriteReply(
                pgid=self.pg.pgid, shard=msg.shard,
                from_osd=self.pg.whoami, tid=msg.tid,
                committed=True, applied=True)
            if local:
                self.handle_sub_write_reply(reply)
            else:
                self.pg.send_to_osd(msg.from_osd, reply)
            done.set()

        txn.register_on_commit(on_commit)
        self.pg.store.queue_transaction(txn)

    def handle_sub_write_reply(self, msg) -> None:
        target = None
        span = None
        with self.lock:
            for op in self.waiting_commit:
                if op.tid == msg.tid:
                    op.pending_commits.discard(msg.shard)
                    span = op.sub_spans.pop(msg.shard, None)
                    target = op
                    break
        if span is not None:
            span.finish()
        if target is not None:
            self._try_finish_rmw(target)

    # =================================================================
    # read path
    # =================================================================

    def objects_read(self, oid, off: int, length: int, on_done,
                     trace=NULL_SPAN) -> None:
        """Async logical read [off, off+length) -> on_done(bytes|None).

        Sub-reads the covering chunk range from the available shards
        (data shards when whole, any k when degraded), decodes if any
        data shard is missing, slices the requested range."""
        self._start_read(oid, off, length, on_done, trace=trace)

    def _start_read(self, oid, off, length, on_done,
                    internal: bool = False, trace=NULL_SPAN) -> None:
        size = self._object_logical_size(oid)
        if size == 0:
            on_done(b"" if not internal else None)
            return
        if length == 0:
            length = max(0, size - off)
        end = min(off + length, size)
        if off >= end:
            on_done(b"")
            return
        comp = getattr(self.get_hinfo(oid), "comp_info", None)
        if comp is not None:
            # compressed stored stream (fused write transform):
            # logical offsets don't map to stored chunk offsets — read
            # the WHOLE stored stream; completion decompresses + slices
            chunk_off = 0
            chunk_len = self.get_hinfo(oid).get_total_chunk_size()
        else:
            stripe_off, stripe_len = \
                self.sinfo.offset_len_to_stripe_bounds((off, end - off))
            chunk_off = self.sinfo.aligned_logical_offset_to_chunk_offset(
                stripe_off)
            chunk_len = self.sinfo.aligned_logical_offset_to_chunk_offset(
                stripe_len)

        # opt-in residency read: a resident (pg, oid) entry holds the
        # committed full chunk set, so the read is one tiny d2h of the
        # data rows — zero sub-reads, zero decode (osd_hbm_tier_
        # serve_reads; the tier invalidates on every mutation and on
        # interval changes, so a hit is always current)
        if self._tier_read(oid, off, end, on_done):
            return

        shards_avail = self.pg.acting_shards()
        # a shard whose OSD is still recovering this object would serve
        # STALE bytes — reconstruct around it (peer_missing / the
        # reference's MissingLoc role)
        stale = self.pg.osds_missing_object(oid)
        avail = {s for s, osd in shards_avail.items()
                 if osd != CRUSH_ITEM_NONE and osd not in stale}
        want = {self.codec.chunk_index(i) for i in range(self.k)}
        try:
            to_read = self.codec.minimum_to_decode(want, avail)
        except Exception:
            on_done(None)
            return

        tid = next(self._tids)
        read = _InflightRead(tid, oid, off, end - off, on_done,
                             trace=trace if trace is not None
                             else NULL_SPAN)
        read.want_shards = set(to_read)
        read.chunk_off = chunk_off
        read.chunk_len = chunk_len
        with self.lock:
            self.inflight_reads[tid] = read
        for shard in to_read:
            osd = shards_avail[shard]
            # one child span per shard sub-read, mirroring the write
            # side's per-shard children
            sub_span = read.trace.child("sub_read(shard=%d)" % shard)
            sub_span.keyval("osd", osd)
            read.sub_spans[shard] = sub_span
            t_id, p_id = trace_ctx(sub_span)
            msg = MOSDECSubOpRead(
                pgid=self.pg.pgid, shard=shard, from_osd=self.pg.whoami,
                tid=tid, to_read=[(oid, chunk_off, chunk_len, 0)],
                map_epoch=self.pg.map_epoch(), trace_id=t_id,
                parent_span=p_id)
            if osd == self.pg.whoami:
                self.handle_sub_read(msg, local=True)
            else:
                self.pg.send_to_osd(osd, msg)

    def _object_logical_size(self, oid) -> int:
        return self.get_hinfo(oid).get_total_logical_size(self.sinfo)

    # -- HBM residency consumers ---------------------------------------

    def _tier_key(self, oid) -> tuple:
        return (str(self.pg.pgid), oid)

    def _tier(self):
        return getattr(self.pg.daemon, "hbm_tier", None)

    def _tier_read(self, oid, off: int, end: int, on_done) -> bool:
        """Serve a read straight from the resident chunk set (opt-in:
        osd_hbm_tier_serve_reads). Returns True when on_done was
        called; False (a miss) falls through to the sub-read path. Only
        the k data rows cross to the host; an error other than a miss
        propagates."""
        daemon = self.pg.daemon
        tier = self._tier()
        if tier is None or not getattr(daemon, "hbm_serve_reads",
                                       False):
            return False
        key = self._tier_key(oid)
        full_dev = tier.get(key)      # counts the hit/miss itself
        if full_dev is None:
            return False
        total = int(full_dev.shape[1])
        chunk = self.sinfo.chunk_size
        if total % chunk:
            return False              # shape drift: a miss
        stripes = total // chunk
        # rows 0..k-1 are the data chunk streams; re-interleave the
        # stripes back into the logical byte order (decode_concat's
        # finish, without the decode) and copy those bytes alone
        logical = full_dev[:self.k].reshape(self.k, stripes, chunk) \
            .permute(1, 0, 2).contiguous().cpu().numpy().reshape(-1)
        comp = getattr(self.get_hinfo(oid), "comp_info", None)
        if comp is not None:
            # resident rows hold the compressed container: inflate
            from . import fused_transform
            raw = fused_transform.bitplane_decompress(
                logical[:int(comp["comp_len"])].tobytes(),
                int(comp["padded_len"]))
            logical = np.frombuffer(
                raw, dtype=np.uint8)[:self.get_hinfo(oid)
                                     .get_total_logical_size(
                                         self.sinfo)]
        if end > logical.size:
            return False              # shape drift: a miss
        on_done(logical[off:end].tobytes())
        return True

    def _tier_reconstruct(self, oid, target_shard: int,
                          chunk_total: int):
        """Rebuild one shard from the RESIDENT survivors — zero
        sub-reads, zero extra h2d (the decode runs over chunks already
        in device memory; only the rebuilt shard crosses back). Returns
        bytes, or None on a miss (absent, evicted, or a shape that no
        longer matches), which sends the caller down its network path;
        any other error propagates."""
        tier = self._tier()
        if tier is None:
            return None
        key = self._tier_key(oid)
        inv = {self.codec.chunk_index(i): i for i in range(self.n)}
        row = inv.get(target_shard)
        if row is None:
            return None
        try:
            if getattr(self.codec, "alpha", 1) > 1:
                # sub-symbol codec (msr): the resident rows are chunk
                # STREAMS, but the codeword boundary is the per-stripe
                # chunk — reshape to [S, n, chunk] and decode per
                # stripe on device (tier.reconstruct's whole-stream
                # rows are only valid for byte-linear codecs)
                rebuilt = self._tier_reconstruct_striped(tier, key, row)
            else:
                # reconstruct() accounts the hit (or KeyError + miss)
                rebuilt = tier.reconstruct(key, (row,))[0] \
                    .cpu().numpy()
        except (KeyError, _TierMiss):
            return None
        data = rebuilt.tobytes()
        if len(data) != chunk_total:
            return None   # stale shape (e.g. truncate raced): miss
        return data

    def _tier_reconstruct_striped(self, tier, key, row: int):
        """Stripe-aware resident rebuild for sub-symbol codecs: view
        the resident [n, total] streams as [S, n, chunk] stripes,
        gather the k survivor rows on the tier's device and
        decode_batch over them there; only the rebuilt row is copied to
        the host."""
        full_dev = tier.get(key)      # counts the hit/miss itself
        if full_dev is None:
            raise KeyError(key)
        total = int(full_dev.shape[1])
        if total % self.sinfo.chunk_size:
            raise _TierMiss("stream not chunk-aligned")
        stripes = total // self.sinfo.chunk_size
        arr = full_dev.reshape(self.n, stripes,
                               self.sinfo.chunk_size).permute(1, 0, 2)
        avail = tuple(r for r in range(self.n) if r != row)[:self.k]
        idx = torch.tensor(avail, dtype=torch.long, device=full_dev.device)
        survivors = arr.index_select(1, idx)
        all_rows = self.codec.decode_batch(avail, survivors)
        return all_rows[:, row, :].contiguous().cpu().numpy().reshape(-1)

    def handle_sub_read(self, msg, local: bool = False) -> None:
        """Raw per-shard store read (:982-1012) — no decode here.

        Full-shard reads additionally verify the stored bytes against
        the write-time hinfo crc (the reference's handle_sub_read crc
        check): silent bit-rot becomes an EIO in the reply, so the
        primary reconstructs around it exactly like a loud disk error
        instead of decoding garbage into the client's buffer."""
        span = self.pg.daemon.tracer.continue_trace(
            "ec_sub_read", getattr(msg, "trace_id", 0),
            getattr(msg, "parent_span", 0))
        span.keyval("shard", msg.shard)
        reply = MOSDECSubOpReadReply(
            pgid=self.pg.pgid, shard=msg.shard, from_osd=self.pg.whoami,
            tid=msg.tid)
        for oid, chunk_off, chunk_len, _flags in msg.to_read:
            try:
                data = self.pg.local_read_shard(msg.shard, oid,
                                                chunk_off, chunk_len)
                if chunk_off == 0 and not self._shard_crc_ok(
                        oid, msg.shard, data):
                    raise OSError(5, "shard %d of %r failed crc"
                                  % (msg.shard, oid))
                if chunk_len and len(data) < chunk_len:
                    # shard shorter than requested (e.g. mid-recovery):
                    # zero-pad so decode sees equal-length streams
                    data = data + b"\0" * (chunk_len - len(data))
                reply.buffers_read.setdefault(oid, []).append(
                    (chunk_off, data))
            except (OSError, KeyError) as e:
                reply.errors[oid] = getattr(e, "errno", None) or 5
                # clog from the shard that failed (the reference's
                # ECBackend.cc:999 "Error(s) ignored" clog role)
                clog = getattr(self.pg.daemon, "clog", None)
                if clog is not None:
                    clog.error("pg %s: error reading shard %d of %r: "
                               "%s" % (self.pg.pgid, msg.shard, oid, e))
        for name in msg.attrs_to_read:
            reply.attrs_read[name] = self.pg.local_getattr(
                msg.to_read[0][0], name)
        span.finish()
        if local:
            self.handle_sub_read_reply(reply)
        else:
            self.pg.send_to_osd(msg.from_osd, reply)

    def _shard_crc_ok(self, oid, shard: int, data: bytes) -> bool:
        """True when the bytes are trustworthy: only a read covering
        the WHOLE shard stream can be checked against the cumulative
        hinfo crc (partial reads pass through unverified — deep scrub
        owns those)."""
        try:
            h = self.get_hinfo(oid)
        except Exception:
            return True
        if not h.has_chunk_hash() or h.get_total_chunk_size() == 0:
            return True
        if len(data) != h.get_total_chunk_size():
            return True
        import zlib
        return (zlib.crc32(data) & 0xFFFFFFFF) == h.get_chunk_hash(shard)

    def handle_sub_read_reply(self, msg) -> None:
        bad_oid = None
        done_span = None
        with self.lock:
            read = self.inflight_reads.get(msg.tid)
            if read is None:
                return
            done_span = read.sub_spans.pop(msg.shard, None)
            if msg.errors:
                bad_oid = read.oid
                read.errors[msg.shard] = msg.errors
                # error on a shard: try to substitute another shard
                shards_avail = self.pg.acting_shards()
                stale = self.pg.osds_missing_object(read.oid)
                avail = {s for s, osd in shards_avail.items()
                         if osd != CRUSH_ITEM_NONE
                         and osd not in stale
                         and s not in read.errors
                         and s not in read.want_shards}
                if avail:
                    sub = min(avail)
                    read.want_shards.discard(msg.shard)
                    read.want_shards.add(sub)
                    resend = (sub, shards_avail[sub])
                else:
                    self.inflight_reads.pop(msg.tid, None)
                    on_done, read = read.on_done, None
            else:
                for oid, bufs in msg.buffers_read.items():
                    data = b"".join(b for _off, b in bufs)
                    read.shard_data[msg.shard] = data
                resend = None
        if done_span is not None:
            if msg.errors:
                done_span.keyval("error", True)
            done_span.finish()
        if bad_oid is not None:
            # the bad shard is treated as missing for THIS read, and
            # self-healed behind it: reconstruct from the survivors
            # and rewrite it in place (l_osd_read_err/l_osd_repaired
            # accounting; repair_shard dedups concurrent reads)
            self.pg.daemon.perf.inc("read_err")
            bad_osd = self.pg.acting_shards().get(msg.shard)
            if bad_osd is not None and bad_osd != CRUSH_ITEM_NONE:
                self.pg.repair_shard(bad_oid, msg.shard, bad_osd)
        if read is None:
            on_done(None)
            return
        if msg.errors and resend is not None:
            sub, osd = resend
            sub_span = read.trace.child("sub_read(shard=%d)" % sub)
            sub_span.keyval("osd", osd)
            sub_span.keyval("substituted_for", msg.shard)
            with self.lock:
                read.sub_spans[sub] = sub_span
            t_id, p_id = trace_ctx(sub_span)
            m = MOSDECSubOpRead(
                pgid=self.pg.pgid, shard=sub, from_osd=self.pg.whoami,
                tid=msg.tid,
                to_read=[(read.oid, read.chunk_off, read.chunk_len, 0)],
                map_epoch=self.pg.map_epoch(), trace_id=t_id,
                parent_span=p_id)
            if osd == self.pg.whoami:
                self.handle_sub_read(m, local=True)
            else:
                self.pg.send_to_osd(osd, m)
            return
        self._maybe_complete_read(msg.tid)

    def _maybe_complete_read(self, tid) -> None:
        with self.lock:
            read = self.inflight_reads.get(tid)
            if read is None:
                return
            if set(read.shard_data) != read.want_shards:
                return
            self.inflight_reads.pop(tid)
        for span in read.sub_spans.values():
            span.finish()        # stragglers (substituted-away shards)
        read.sub_spans = {}
        if read.raw_shards_cb is not None:
            read.raw_shards_cb(dict(read.shard_data))
            return
        # reassemble: decode the chunk streams back to logical bytes
        dec_span = read.trace.child("ec_decode")
        try:
            out = ec_util.decode_concat(
                self.sinfo, self.codec, dict(read.shard_data),
                dispatcher=getattr(self.pg.daemon, "gpu_dispatcher",
                                   None),
                trace=dec_span)
        except Exception:
            dec_span.finish()
            read.on_done(None)
            return
        dec_span.finish()
        comp = getattr(self.get_hinfo(read.oid), "comp_info", None)
        if comp is not None:
            # the decoded stream is the compressed container (fused
            # write transform): inflate it back to the logical bytes
            from . import fused_transform
            try:
                out = fused_transform.bitplane_decompress(
                    out[:int(comp["comp_len"])],
                    int(comp["padded_len"]))
            except Exception:
                read.on_done(None)
                return
            out = out[:self.get_hinfo(read.oid)
                      .get_total_logical_size(self.sinfo)]
            read.on_done(out[read.off:read.off + read.length])
            return
        stripe_off = self.sinfo.aligned_chunk_offset_to_logical_offset(
            read.chunk_off)
        start = read.off - stripe_off
        read.on_done(out[start:start + read.length])

    # =================================================================
    # recovery (reconstruct one shard and push it)
    # =================================================================

    def recover_object(self, oid, target_shard: int, on_done) -> None:
        """Reconstruct target_shard's chunk stream from k survivors.

        continue_recovery_op reshaped: read the full chunk streams from
        the available shards, decode-all (ONE batched device call),
        hand the target shard's bytes + attrs to on_done(shard_bytes)."""
        h = self.get_hinfo(oid)
        if getattr(h, "comp_info", None) is not None:
            # compressed object: the shard streams on disk are the
            # STORED (compressed) length, not the logical-derived one
            chunk_total = h.get_total_chunk_size()
        else:
            size = self._object_logical_size(oid)
            chunk_total = \
                self.sinfo.aligned_logical_offset_to_chunk_offset(
                    self.sinfo.logical_to_next_stripe_offset(size))
        if chunk_total == 0:
            on_done(b"")
            return
        # residency first: the resident chunk set rebuilds the shard
        # on device with ZERO sub-reads and zero extra h2d — scrub
        # repair and recovery both land here (ROADMAP direction A /
        # carried item 1); a miss (evicted, never adopted, invalidated)
        # falls through to the survivor sub-read path below
        resident = self._tier_reconstruct(oid, target_shard,
                                          chunk_total)
        if resident is not None:
            on_done(resident)
            return
        # repair-bandwidth-optimal path (ROADMAP direction C): when the
        # codec advertises fraction repair, helpers compute and ship
        # only beta-fraction symbols (chunk/alpha bytes each) and the
        # primary reconstructs on device — d*chunk/alpha total traffic
        # instead of k*chunk. Fewer than d live helpers (or any combine
        # failure) falls back to the full-survivor decode below.
        if self._try_repair(oid, target_shard, chunk_total, on_done):
            return
        self._recover_survivors(oid, target_shard, chunk_total, on_done)

    def _recover_survivors(self, oid, target_shard: int,
                           chunk_total: int, on_done) -> None:
        """Full-survivor recovery: read k whole chunk streams and
        decode (the classic path; also the repair path's fallback)."""
        shards_avail = self.pg.acting_shards()
        stale = self.pg.osds_missing_object(oid)
        avail = {s for s, osd in shards_avail.items()
                 if osd != CRUSH_ITEM_NONE and s != target_shard
                 and osd not in stale}
        tid = next(self._tids)
        read = _InflightRead(tid, oid, 0, 0, None)
        # the codec picks the repair set: for RS any k survivors, for
        # locality codecs (lrc/shec) the local group — fewer reads AND
        # the only set guaranteed decodable
        try:
            use = tuple(sorted(self.codec.minimum_to_decode(
                {target_shard}, avail)))
        except Exception:
            on_done(None)
            return
        if not use:
            on_done(None)
            return
        read.want_shards = set(use)
        read.chunk_off = 0
        read.chunk_len = chunk_total

        def finish(shard_data: dict):
            # cross-chip leg (ROADMAP direction D): with more than
            # one local device the survivor chunk streams shard
            # across the mesh and reconstruct in place, guarded by a
            # psum checksum — the survivors never gather onto the
            # primary's chip.  Any mesh failure (checksum trip,
            # single device, locality codec) falls back to the
            # host-buffered decode below, which still holds the
            # bytes as received.
            try:
                rebuilt = ec_util.recover_cross_chip(
                    self.sinfo, self.codec, shard_data, target_shard)
            except (MeshChecksumError, ErasureCodeError):
                rebuilt = None
            if rebuilt is not None:
                on_done(rebuilt)
                return
            try:
                decoded = ec_util.decode(self.sinfo, self.codec,
                                         shard_data,
                                         want={target_shard})
            except Exception:
                on_done(None)
                return
            on_done(np.asarray(
                decoded[target_shard], dtype=np.uint8).tobytes())

        read.raw_shards_cb = finish
        read.on_done = lambda _data: on_done(None)  # error path only
        with self.lock:
            self.inflight_reads[tid] = read
        for shard in use:
            osd = shards_avail[shard]
            msg = MOSDECSubOpRead(
                pgid=self.pg.pgid, shard=shard, from_osd=self.pg.whoami,
                tid=tid, to_read=[(oid, 0, chunk_total, 0)],
                map_epoch=self.pg.map_epoch())
            if osd == self.pg.whoami:
                self.handle_sub_read(msg, local=True)
            else:
                self.pg.send_to_osd(osd, msg)

    # =================================================================
    # regenerating-code repair (beta-fraction helper reads)
    # =================================================================

    def _count_repair(self, which: str, nbytes: int) -> None:
        """l_osd_repair_bytes_* accounting (best-effort like
        pg._count_push: harnesses run against daemon stubs without the
        full counter set)."""
        perf = getattr(self.pg.daemon, "perf", None)
        if perf is None:
            return
        try:
            perf.inc("l_osd_repair_bytes_%s" % which, nbytes)
        except KeyError:
            pass

    def _repair_helpers_avail(self, oid, target_shard: int) -> tuple:
        shards_avail = self.pg.acting_shards()
        stale = self.pg.osds_missing_object(oid)
        avail = {s for s, osd in shards_avail.items()
                 if osd != CRUSH_ITEM_NONE and s != target_shard
                 and osd not in stale}
        return shards_avail, avail

    def _try_repair(self, oid, target_shard: int, chunk_total: int,
                    on_done) -> bool:
        """Launch a beta-fraction repair when the codec supports it and
        enough helpers are live. Returns False (caller degrades to the
        full-survivor decode) otherwise."""
        codec = self.codec
        if not getattr(codec, "supports_repair", lambda: False)():
            return False
        try:
            if not self.pg.daemon.ctx.conf.get_val(
                    "osd_ec_repair_enable"):
                return False
        except (AttributeError, KeyError):
            pass
        if chunk_total % self.sinfo.chunk_size:
            return False
        shards_avail, avail = self._repair_helpers_avail(oid,
                                                         target_shard)
        try:
            helpers = codec.minimum_to_repair(target_shard, avail)
        except Exception:
            return False   # fewer than d live helpers
        tid = next(self._tids)
        rep = _InflightRepair(
            tid, oid, target_shard, chunk_total, on_done,
            fallback=lambda: self._recover_survivors(
                oid, target_shard, chunk_total, on_done))
        rep.helpers = set(helpers)
        rep.tried = set(helpers)
        with self.lock:
            self.inflight_repairs[tid] = rep
        for shard in sorted(helpers):
            self._send_repair_read(rep, shard, shards_avail)
        return True

    def _send_repair_read(self, rep, shard: int,
                          shards_avail: dict) -> None:
        msg = MOSDECSubOpRepairRead(
            pgid=self.pg.pgid, shard=shard, from_osd=self.pg.whoami,
            tid=rep.tid, oid=rep.oid, target_shard=rep.target_shard,
            chunk_len=rep.chunk_total, map_epoch=self.pg.map_epoch())
        osd = shards_avail.get(shard)
        if osd == self.pg.whoami:
            self.handle_repair_read(msg, local=True)
        else:
            self.pg.send_to_osd(osd, msg)

    def handle_repair_read(self, msg, local: bool = False) -> None:
        """Helper side: read own shard stream, verify its crc, project
        it to the beta fraction ON THIS OSD's device, ship only that.
        A read error becomes an errno reply so the primary substitutes
        another helper (repair bytes are counted only on success, so a
        failed helper never inflates the traffic accounting)."""
        reply = MOSDECSubOpRepairReadReply(
            pgid=self.pg.pgid, shard=msg.shard,
            from_osd=self.pg.whoami, tid=msg.tid, oid=msg.oid)
        try:
            data = self.pg.local_read_shard(msg.shard, msg.oid, 0,
                                            msg.chunk_len)
            if not self._shard_crc_ok(msg.oid, msg.shard, data):
                raise OSError(5, "shard %d of %r failed crc"
                              % (msg.shard, msg.oid))
            if msg.chunk_len and len(data) < msg.chunk_len:
                data = data + b"\0" * (msg.chunk_len - len(data))
            reply.fraction = ec_util.repair_fraction(
                self.sinfo, self.codec, msg.target_shard, data,
                dispatcher=getattr(self.pg.daemon, "gpu_dispatcher",
                                   None))
            self._count_repair("read", len(data))
            self._count_repair("shipped", len(reply.fraction))
        except (OSError, KeyError, ErasureCodeError) as e:
            reply.error = getattr(e, "errno", None) or 5
            clog = getattr(self.pg.daemon, "clog", None)
            if clog is not None:
                clog.error("pg %s: repair fraction of shard %d of %r "
                           "failed: %s" % (self.pg.pgid, msg.shard,
                                           msg.oid, e))
        if local:
            self.handle_repair_read_reply(reply)
        else:
            self.pg.send_to_osd(msg.from_osd, reply)

    def handle_repair_read_reply(self, msg) -> None:
        """Primary side: collect fractions; on a helper error
        substitute an untried helper (any d survivors work for the
        product-matrix construction) or abandon to the full-survivor
        decode; combine when all d fractions are in."""
        fallback = None
        resend = None
        done = None
        bad = False
        with self.lock:
            rep = self.inflight_repairs.get(msg.tid)
            if rep is None:
                return
            if msg.error:
                bad = msg.shard in rep.helpers
                rep.helpers.discard(msg.shard)
                rep.fractions.pop(msg.shard, None)
                shards_avail, avail = self._repair_helpers_avail(
                    rep.oid, rep.target_shard)
                candidates = avail - rep.tried
                if candidates:
                    sub = min(candidates)
                    rep.helpers.add(sub)
                    rep.tried.add(sub)
                    resend = (rep, sub, shards_avail)
                else:
                    self.inflight_repairs.pop(msg.tid, None)
                    fallback = rep.fallback
            else:
                # accept only an awaited, not-yet-delivered fraction:
                # a duplicate delivery must not double-collect
                if msg.shard in rep.helpers and \
                        msg.shard not in rep.fractions:
                    rep.fractions[msg.shard] = msg.fraction
                if set(rep.fractions) == rep.helpers and \
                        len(rep.fractions) == \
                        self.codec.repair_helper_count():
                    self.inflight_repairs.pop(msg.tid, None)
                    done = rep
        if bad:
            # same self-heal as the read path: the helper's shard
            # failed its crc/read — rewrite it behind this rebuild
            self.pg.daemon.perf.inc("read_err")
            bad_osd = self.pg.acting_shards().get(msg.shard)
            if bad_osd is not None and bad_osd != CRUSH_ITEM_NONE:
                self.pg.repair_shard(msg.oid, msg.shard, bad_osd)
        if fallback is not None:
            fallback()
            return
        if resend is not None:
            rep, sub, shards_avail = resend
            self._send_repair_read(rep, sub, shards_avail)
            return
        if done is not None:
            self._finish_repair(done)

    def _finish_repair(self, rep) -> None:
        """All d fractions in: combine on device — mesh psum path
        first (parallel.mesh.repair_sharded), then the dispatcher/host
        combine; a checksum trip or fractions that do not fit degrade to
        the full-survivor decode."""
        out = None
        try:
            out = ec_util.repair_cross_chip(
                self.sinfo, self.codec, rep.target_shard,
                dict(rep.fractions))
        except (MeshChecksumError, ErasureCodeError):
            out = None
        if out is None:
            try:
                out = ec_util.repair_combine(
                    self.sinfo, self.codec, rep.target_shard,
                    dict(rep.fractions),
                    dispatcher=getattr(self.pg.daemon,
                                       "gpu_dispatcher", None))
            except ErasureCodeError:
                rep.fallback()
                return
        shipped = sum(len(v) for v in rep.fractions.values())
        self._count_repair(
            "saved", max(0, self.k * rep.chunk_total - shipped))
        rep.on_done(out)
