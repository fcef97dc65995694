"""Typed messages: the EC sub-ops.

Port of ``ceph_tpu/msg/message.py``, in part: the ``Message`` base
(:43) and the six EC sub-op messages ECBackend exchanges with its shard
OSDs (:128-213), field for field, so either package's backend reads the
other's messages. The rest of the catalog (client ops, replicated
sub-ops, maps, peering, heartbeats, monitor and manager traffic) and the
versioned binary encoding wait for the messenger's slice.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

__all__ = [
    "Message", "MOSDECSubOpWrite", "MOSDECSubOpWriteReply",
    "MOSDECSubOpRead", "MOSDECSubOpReadReply", "MOSDECSubOpRepairRead",
    "MOSDECSubOpRepairReadReply",
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
