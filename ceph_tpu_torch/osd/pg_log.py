"""Per-PG operation log with authoritative-log merge.

Port of ``ceph_tpu/osd/pg_log.py``, host code the port keeps its own
copy of.

Role of the reference's PGLog (src/osd/PGLog.{h,cc}, 2,974 LoC) and the
peering log machinery (doc/dev/osd_internals/log_based_pg.rst,
doc/dev/osd_internals/erasure_coding/ecbackend.rst:149-174): every
write appends a log entry stamped with an eversion — (map epoch,
version) — and peering converges replicas by comparing LOGS, not by
scanning object inventories:

  - the peer with the highest last_update owns the authoritative log;
  - entries the authoritative log has beyond ours become `missing`
    (oid -> the version we need) and drive targeted recovery;
  - OUR entries beyond the last common point are DIVERGENT — written
    in a dead interval, never acked against the surviving quorum's
    chain — and are undone: a divergent create is removed, a divergent
    modify/delete reverts to the authoritative object (via recovery,
    the "cannot rollback -> add to missing" lane of PGLog::_merge_
    object_divergent_entries; EC roll-forward semantics fall out of
    the same rule because acked entries are by construction on every
    surviving shard's log).

The epoch half of the eversion is what makes fork detection sound: two
primaries of different intervals minting version N produce entries
(e1, N) != (e2, N), so the divergent one cannot masquerade as the
acked one (the failure class plain version counters cannot see).
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["LogEntry", "PGLog", "entry_from_tuple"]


@dataclass
class LogEntry:
    """One journaled PG operation (pg_log_entry_t). reqid carries the
    client's (session, tid) so a new primary can dedup retransmits
    across failover (pg_log_entry_t::reqid exactly-once role)."""
    epoch: int = 0
    version: int = 0
    oid: str = ""
    kind: str = "modify"          # modify | delete
    prior_version: int = 0
    reqid: tuple = ("", 0)

    @property
    def ev(self) -> tuple:
        return (self.epoch, self.version)


def entry_from_tuple(t) -> LogEntry:
    """Canonical wire/durable row: (epoch, version, oid, kind, prior
    [, session, tid]). Legacy 3-tuples (version, oid, kind) still
    parse (epoch 0)."""
    if isinstance(t, LogEntry):
        return t
    if len(t) >= 7:
        return LogEntry(epoch=t[0], version=t[1], oid=t[2], kind=t[3],
                        prior_version=t[4], reqid=(t[5], t[6]))
    if len(t) >= 5:
        return LogEntry(epoch=t[0], version=t[1], oid=t[2], kind=t[3],
                        prior_version=t[4])
    return LogEntry(epoch=0, version=t[0], oid=t[1], kind=t[2])


class PGLog:
    """Ordered entry list + oid index + missing map."""

    CAP = 5000

    def __init__(self):
        self.entries: list[LogEntry] = []
        self.head: tuple = (0, 0)     # eversion of newest entry
        self.tail: tuple = (0, 0)     # everything before this is trimmed
        # oid -> version we need (0 = must not exist / delete local)
        self.missing: dict = {}

    def __len__(self):
        return len(self.entries)

    def append(self, entry: LogEntry) -> list:
        """Returns the entries trimmed off the tail (so the durable
        omap can drop their keys — the on-disk log must not grow
        unboundedly while the in-memory one caps at CAP)."""
        self.entries.append(entry)
        if entry.ev > self.head:
            self.head = entry.ev
        return self._trim()

    def _trim(self) -> list:
        dropped: list = []
        if len(self.entries) > self.CAP:
            drop = len(self.entries) - self.CAP
            dropped = self.entries[:drop]
            self.entries = self.entries[drop:]
            self.tail = self.entries[0].ev
        return dropped

    def has_ev(self, ev: tuple) -> bool:
        return any(e.ev == tuple(ev) for e in self.entries)

    def entries_since(self, ev: tuple) -> list[LogEntry]:
        """Entries strictly after eversion ev, in order."""
        ev = tuple(ev)
        return [e for e in self.entries if e.ev > ev]

    def overlaps(self, ev: tuple) -> bool:
        """Can this log serve a delta from `ev`? True when ev is within
        [tail, head] (an empty start, (0,0), overlaps iff the log's
        tail is still the very beginning)."""
        ev = tuple(ev)
        if ev == self.head:
            return True
        if ev >= self.tail and (ev == (0, 0) or self.has_ev(ev)):
            return True
        return False

    def latest_for_oid(self, oid) -> LogEntry | None:
        for e in reversed(self.entries):
            if e.oid == oid:
                return e
        return None

    # -- authoritative merge -------------------------------------------

    def merge(self, auth_entries: list[LogEntry], auth_head: tuple
              ) -> tuple:
        """Merge an authoritative log segment into this log
        (PGLog::merge_log). Returns (updates, divergent_oids):
        updates maps oid -> need version (int > 0: recover that
        version; 0: the object must not exist locally); divergent_oids
        names objects whose LOCAL copy was written in a dead interval —
        its version xattr is a lie from a fork, so the store copy must
        be dropped before recovery, never version-compared against the
        authoritative copy.

        The last COMMON eversion splits both logs: auth entries after
        it are to-apply (missing); our entries after it are divergent
        and get undone toward the authoritative object state."""
        auth_head = tuple(auth_head)
        auth_evs = {e.ev for e in auth_entries}
        # last common point. Preferred: the newest of our entries that
        # the authoritative segment also contains. When the segment
        # shares nothing with us, it is either a contiguous extension
        # (starts past our head) or a rewind to auth_head known to be
        # in our chain — both bound the common prefix by
        # min(head, auth_head). A segment reaching below our head that
        # still shares nothing means we forked before its start: only
        # our tail is provably common.
        common = None
        for e in self.entries:
            if e.ev in auth_evs:
                common = e.ev if common is None else max(common, e.ev)
        if common is None:
            common = min(self.head, auth_head)
            if auth_entries and \
                    min(e.ev for e in auth_entries) <= common:
                common = min(self.tail, common)
        updates: dict = {}
        divergent_oids: set = set()

        # 1. divergent local entries (ours, newer than common, not in
        #    the authoritative chain)
        divergent = [e for e in self.entries
                     if e.ev > common and e.ev not in auth_evs]
        divergent_oids = {e.oid for e in divergent}
        auth_latest: dict = {}
        for e in auth_entries:
            auth_latest[e.oid] = e
        reverted: set = set()
        for e in divergent:
            ae = auth_latest.get(e.oid)
            if ae is not None and ae.ev <= auth_head:
                # authoritative chain has its own (older or newer)
                # truth for the object
                updates[e.oid] = 0 if ae.kind == "delete" else \
                    ae.version
            elif e.oid not in reverted:
                # the object's only history beyond common is divergent:
                # revert to its state AT common — the EARLIEST divergent
                # entry's prior_version (later divergent entries' priors
                # are themselves divergent versions nobody can serve)
                updates[e.oid] = e.prior_version
                reverted.add(e.oid)
        # drop divergent entries from our log (rewind)
        self.entries = [e for e in self.entries
                        if e.ev <= common or e.ev in auth_evs]

        # 2. apply the authoritative delta
        for e in sorted(auth_entries, key=lambda x: x.ev):
            if e.ev <= common:
                continue
            updates[e.oid] = 0 if e.kind == "delete" else e.version
            self.entries.append(e)
        self.entries.sort(key=lambda x: x.ev)
        self.head = max(auth_head, common)
        self._trim()
        return updates, divergent_oids

    # -- (de)serialization ---------------------------------------------

    def dump(self) -> list:
        return [(e.epoch, e.version, e.oid, e.kind, e.prior_version,
                 e.reqid[0], e.reqid[1]) for e in self.entries]

    def load(self, rows: list) -> None:
        self.entries = [entry_from_tuple(r) for r in rows]
        self.entries.sort(key=lambda e: e.ev)
        if self.entries:
            self.head = self.entries[-1].ev
            self.tail = self.entries[0].ev
        self._trim()
