"""Typed messages: what an OSD's PG exchanges.

Port of ``ceph_tpu/msg/message.py``, in part, field for field, so either
package's PG and backend read the other's messages: the ``Message`` base
(:43), the client op and its reply with the op flags and the read-op set
(:74-125), the six EC sub-ops ECBackend exchanges with its shard OSDs
(:128-213), the replicated sub-ops (:216-240), recovery's push, scan and
pull (:241-277), the reservation round (:278), peering's query, notify
and log (:301-342) and watch/notify (:343-365). The rest of the catalog
(pings, maps, boot and failure reports, the monitor's, manager's, MDS's,
auth's and paxos' messages) and the versioned binary encoding
(``codecs.py``) wait for the messenger's slice.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

__all__ = [
    "Message", "MOSDOp", "MOSDOpReply", "OSD_FLAG_IGNORE_CACHE",
    "OSD_READ_OPS", "MOSDECSubOpWrite", "MOSDECSubOpWriteReply",
    "MOSDECSubOpRead", "MOSDECSubOpReadReply", "MOSDECSubOpRepairRead",
    "MOSDECSubOpRepairReadReply", "MOSDRepOp", "MOSDRepOpReply",
    "MOSDPGPush", "MOSDPGScan", "MOSDPGPull", "MBackfillReserve",
    "MOSDPGQuery", "MOSDPGNotify", "MOSDPGLog", "MWatchNotify",
    "MWatchNotifyAck",
]

_seq = itertools.count(1)


@dataclass
class Message:
    """Base: source entity + transport-stamped fields."""

    def __post_init__(self):
        self.seq = next(_seq)
        self.from_name = None      # ("osd", 3) / ("client", 1) / ("mon", 0)
        self.from_addr = None

    def get_type(self) -> str:
        return self.__class__.__name__


# -- client data plane -------------------------------------------------

@dataclass
class MOSDOp(Message):
    """Client -> primary OSD op (src/messages/MOSDOp.h)."""
    client_id: int = 0
    tid: int = 0
    pgid: object = None            # PGID (raw)
    oid: str = ""
    ops: list = field(default_factory=list)  # [(op, args...)]
    map_epoch: int = 0
    # snapshots (appended fields — compatible evolution):
    snapc: tuple = (0, ())         # write SnapContext (seq, snaps desc)
    snap: int = 0                  # read snap id (0 = head)
    session: str = ""              # per-client nonce: the dedup key
                                   # survives client-id/tid reuse
                                   # across processes
    flags: int = 0                 # OSD_FLAG_* (appended field)
    # tracing context (ZTracer envelope role, appended fields): the
    # client's trace id + the span the OSD's spans nest under; 0 = op
    # not traced
    trace_id: int = 0
    parent_span: int = 0
    # dmclock feedback (appended fields): service this client received
    # cluster-wide since its previous op to the target OSD, in op-queue
    # min_cost units — delta counts every completion, rho only
    # reservation-phase ones (Gulati et al., the distributed half)
    qos_delta: float = 0.0
    qos_rho: float = 0.0


# CEPH_OSD_FLAG_IGNORE_CACHE (src/include/rados.h): run the op on the
# addressed pool directly — no cache-tier promote/proxy interposition
OSD_FLAG_IGNORE_CACHE = 1

# The op kinds that never mutate (CEPH_OSD_OP_MODE_RD set). ONE shared
# definition: the client's overlay routing, the PG's read/write split,
# and the tier's promote decision must all agree on what a read is.
OSD_READ_OPS = frozenset(("read", "stat", "getxattr", "getxattrs",
                          "omap_get", "list", "list_snaps",
                          "copy_get"))


@dataclass
class MOSDOpReply(Message):
    tid: int = 0
    result: int = 0
    data: object = None
    map_epoch: int = 0
    # dmclock phase that served the op (appended field): "" before the
    # QoS queue saw it, else strict|reservation|proportional — clients
    # accumulate rho from reservation-phase completions only
    qos_phase: str = ""


# -- EC sub-ops (src/osd/ECMsgTypes.h via MOSDECSubOp*) ----------------

@dataclass
class MOSDECSubOpWrite(Message):
    pgid: object = None
    shard: int = 0                 # target shard id
    from_osd: int = 0
    tid: int = 0
    at_version: int = 0
    trim_to: int = 0
    roll_forward_to: int = 0
    log_entries: list = field(default_factory=list)
    txn_ops: list = field(default_factory=list)   # store Transaction.ops
    backfill: bool = False
    map_epoch: int = 0
    instance: str = ""             # sender-incarnation nonce (dedup)
    trace_id: int = 0              # tracing envelope (appended): the
    parent_span: int = 0           # primary's per-shard child span


@dataclass
class MOSDECSubOpWriteReply(Message):
    pgid: object = None
    shard: int = 0
    from_osd: int = 0
    tid: int = 0
    last_complete: int = 0
    committed: bool = False
    applied: bool = False


@dataclass
class MOSDECSubOpRead(Message):
    pgid: object = None
    shard: int = 0
    from_osd: int = 0
    tid: int = 0
    to_read: list = field(default_factory=list)   # [(oid, off, len, flags)]
    attrs_to_read: list = field(default_factory=list)
    map_epoch: int = 0
    trace_id: int = 0              # tracing envelope (appended): the
    parent_span: int = 0           # primary's per-shard read span


@dataclass
class MOSDECSubOpReadReply(Message):
    pgid: object = None
    shard: int = 0
    from_osd: int = 0
    tid: int = 0
    buffers_read: dict = field(default_factory=dict)  # oid -> [(off, bytes)]
    attrs_read: dict = field(default_factory=dict)
    errors: dict = field(default_factory=dict)        # oid -> errno


@dataclass
class MOSDECSubOpRepairRead(Message):
    """Primary -> helper: ship the beta-fraction repair symbols of one
    object's shard for a regenerating-code rebuild (the sub-op variant
    that carries fractions, not chunks — repair traffic is
    chunk/alpha per helper instead of a full chunk)."""
    pgid: object = None
    shard: int = 0                 # helper shard asked for its fraction
    from_osd: int = 0
    tid: int = 0
    oid: str = ""
    target_shard: int = -1         # shard being rebuilt
    chunk_len: int = 0             # full shard stream length expected
    map_epoch: int = 0
    trace_id: int = 0              # tracing envelope: the primary's
    parent_span: int = 0           # per-helper repair-read span


@dataclass
class MOSDECSubOpRepairReadReply(Message):
    """Helper -> primary: the computed fraction stream (or an errno
    when the shard read/verify failed and the primary should
    substitute another helper)."""
    pgid: object = None
    shard: int = 0
    from_osd: int = 0
    tid: int = 0
    oid: str = ""
    fraction: bytes = b""
    error: int = 0


# -- replicated sub-ops ------------------------------------------------

@dataclass
class MOSDRepOp(Message):
    pgid: object = None
    from_osd: int = 0
    tid: int = 0
    at_version: int = 0
    log_entries: list = field(default_factory=list)
    txn_ops: list = field(default_factory=list)
    map_epoch: int = 0
    instance: str = ""             # sender-incarnation nonce (dedup)
    trace_id: int = 0              # tracing envelope (appended): the
    parent_span: int = 0           # primary's per-peer rep-op span


@dataclass
class MOSDRepOpReply(Message):
    pgid: object = None
    from_osd: int = 0
    tid: int = 0
    result: int = 0
    committed: bool = False


# -- recovery push/pull ------------------------------------------------

@dataclass
class MOSDPGPush(Message):
    pgid: object = None
    from_osd: int = 0
    shard: int = -1
    oid: str = ""
    data: bytes = b""
    attrs: dict = field(default_factory=dict)
    omap: dict = field(default_factory=dict)
    version: int = 0
    map_epoch: int = 0
    force: bool = False    # scrub repair: overwrite same-version bitrot
    delete: bool = False   # divergent-delete propagation: remove, not write


@dataclass
class MOSDPGScan(Message):
    """Primary <-> replica object inventory exchange driving recovery
    (stands in for the reference's pg-log/backfill scan machinery)."""
    pgid: object = None
    from_osd: int = 0
    shard: int = -1
    op: str = "request"            # request | reply
    objects: dict = field(default_factory=dict)   # oid -> version
    deleted: dict = field(default_factory=dict)   # oid -> deleted-at ver
    map_epoch: int = 0


@dataclass
class MOSDPGPull(Message):
    pgid: object = None
    from_osd: int = 0
    shard: int = -1
    oid: str = ""
    map_epoch: int = 0


@dataclass
class MBackfillReserve(Message):
    """Recovery/backfill reservation round-trip between a primary and
    its replicas (src/messages/MBackfillReserve.h +
    MRecoveryReserve.h folded into one type, selected by `lane`).
    The primary sends op=request after winning its LOCAL slot; each
    replica answers grant (remote slot held) or reject (slots busy, or
    the replica is backfillfull for lane=backfill).  op=release frees
    the remote slot on completion/interval change."""
    pgid: object = None
    from_osd: int = 0
    lane: str = "backfill"         # backfill | recovery
    op: str = "request"            # request | grant | reject | release
    priority: int = 0
    map_epoch: int = 0
    # reject cause (appended field): "toofull" = replica refuses the
    # lane on fullness grounds (primary parks in backfill_toofull),
    # "preempted" = a higher-priority PG evicted the remote slot
    reason: str = ""


# -- peering (GetInfo/GetLog/GetMissing rounds) ------------------------

@dataclass
class MOSDPGQuery(Message):
    """Primary asks a peer for its info or its log since an eversion
    (src/messages/MOSDPGQuery.h)."""
    pgid: object = None
    from_osd: int = 0
    shard: int = -1
    what: str = "info"             # info | log
    since: tuple = (0, 0)          # eversion for what=log
    map_epoch: int = 0


@dataclass
class MOSDPGNotify(Message):
    """Peer -> primary: pg info, and (post-merge) the peer's missing
    set (src/messages/MOSDPGNotify.h + the GetMissing leg)."""
    pgid: object = None
    from_osd: int = 0
    shard: int = -1
    info: dict = field(default_factory=dict)
    missing: list = field(default_factory=list)   # [oid, ...]
    map_epoch: int = 0
    kind: str = "info"             # info | missing (GetMissing reply)


@dataclass
class MOSDPGLog(Message):
    """A log segment: authoritative reply to what=log, or the
    activation delta the primary sends each replica
    (src/messages/MOSDPGLog.h)."""
    pgid: object = None
    from_osd: int = 0
    shard: int = -1
    entries: list = field(default_factory=list)   # PGLog.dump() rows
    head: tuple = (0, 0)
    contiguous: bool = True
    info: dict = field(default_factory=dict)
    map_epoch: int = 0


# -- watch/notify ------------------------------------------------------

@dataclass
class MWatchNotify(Message):
    """Primary OSD -> watching client (src/messages/MWatchNotify.h)."""
    pgid: object = None
    oid: str = ""
    cookie: int = 0
    notify_id: int = 0
    payload: bytes = b""
    from_osd: int = -1


@dataclass
class MWatchNotifyAck(Message):
    """Watcher's completion ack back to the notifying primary."""
    pgid: object = None
    oid: str = ""
    cookie: int = 0
    notify_id: int = 0
    reply: bytes = b""
