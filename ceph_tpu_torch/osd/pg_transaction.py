"""Logical per-object operations.

Port of ``ceph_tpu/osd/pg_transaction.py``, host code the port keeps its
own copy of.

Role of the reference's PGTransaction (src/osd/PGTransaction.h): the
PG-level description of what a client op does to objects — creates,
deletes, buffer writes/zeros, truncates, clones/renames, attr and omap
updates — consumed by a backend's planner which turns it into physical
per-shard store transactions. safe_create_traverse orders entries so
clone/rename sources are processed safely.
"""

from __future__ import annotations

__all__ = ["PGTransaction", "ObjectOperation"]


class ObjectOperation:
    def __init__(self):
        self.init_type = "none"        # none | create | clone | rename
        self.source = None             # clone/rename source oid
        self.delete_first = False
        self.truncate = None           # (first, final) like the reference
        self.buffer_updates: list[tuple] = []  # ("write",off,bytes)|("zero",off,len)
        self.attr_updates: dict = {}   # name -> bytes | None (= remove)
        self.omap_updates: dict = {}
        self.omap_rmkeys: list = []

    # -- queries (WritePlan template contract) -------------------------

    def deletes_first(self) -> bool:
        return self.delete_first

    def has_source(self) -> bool:
        return self.source is not None

    def is_fresh_object(self) -> bool:
        return self.init_type == "create" and not self.buffer_updates \
            and self.truncate is None

    def is_none(self) -> bool:
        return self.init_type == "none" and not self.delete_first \
            and not self.buffer_updates and self.truncate is None \
            and not self.attr_updates and not self.omap_updates \
            and not self.omap_rmkeys

    def is_delete(self) -> bool:
        """A pure removal: the object ends the transaction gone."""
        return self.delete_first and self.init_type == "none" \
            and not self.buffer_updates and self.truncate is None \
            and not self.attr_updates and not self.omap_updates


class PGTransaction:
    def __init__(self):
        self.op_map: dict = {}         # oid -> ObjectOperation

    def _get(self, oid) -> ObjectOperation:
        op = self.op_map.get(oid)
        if op is None:
            op = self.op_map[oid] = ObjectOperation()
        return op

    # -- builders (the PrimaryLogPG-facing API) ------------------------

    def create(self, oid) -> None:
        self._get(oid).init_type = "create"

    def remove(self, oid) -> None:
        self.reset_data(oid)
        op = self._get(oid)
        op.delete_first = True
        op.init_type = "none"

    def reset_data(self, oid) -> None:
        """Drop queued data mutations (buffer updates + truncate) while
        keeping attr/omap updates — the data half of what remove() does.
        Used by WRITEFULL, which replaces the object's entire data
        stream but must preserve xattrs (snapset) and omap."""
        op = self._get(oid)
        op.buffer_updates = []
        op.truncate = None

    def drop_attr_update(self, oid, name: str) -> None:
        """Discard a QUEUED setattr — for ops that supersede a marker
        an earlier op in the same compound queued (e.g. WRITEFULL after
        a whiteout-remove). A queued rmattr (value None) is kept: it
        clears persisted state, which still must happen."""
        op = self.op_map.get(oid)
        if op is not None and op.attr_updates.get(name) is not None:
            op.attr_updates.pop(name)

    def write(self, oid, offset: int, data: bytes) -> None:
        self._get(oid).buffer_updates.append(("write", offset, bytes(data)))

    def zero(self, oid, offset: int, length: int) -> None:
        self._get(oid).buffer_updates.append(("zero", offset, length))

    def truncate(self, oid, size: int) -> None:
        op = self._get(oid)
        if op.truncate is None:
            op.truncate = (size, size)
        else:
            op.truncate = (op.truncate[0], size)

    def clone(self, src, dst) -> None:
        op = self._get(dst)
        op.init_type = "clone"
        op.source = src

    def rename(self, src, dst) -> None:
        op = self._get(dst)
        op.init_type = "rename"
        op.source = src
        # the source ceases to exist
        self._get(src).delete_first = True

    def setattr(self, oid, name: str, value) -> None:
        self._get(oid).attr_updates[name] = value

    def rmattr(self, oid, name: str) -> None:
        self._get(oid).attr_updates[name] = None

    def omap_setkeys(self, oid, kv: dict) -> None:
        # the builders are called in op-vector order; make the merged
        # record order-independent by letting the LAST logical op per
        # key win (a set cancels a queued rm of the same key — e.g.
        # OMAPCLEAR followed by OMAPSETKEYS in one compound op)
        op = self._get(oid)
        op.omap_updates.update(kv)
        if op.omap_rmkeys:
            op.omap_rmkeys = [k for k in op.omap_rmkeys if k not in kv]

    def omap_rmkeys_op(self, oid, keys) -> None:
        op = self._get(oid)
        op.omap_rmkeys.extend(keys)
        for k in keys:
            op.omap_updates.pop(k, None)

    # -- traversal -----------------------------------------------------

    def safe_create_traverse(self):
        """Yield (oid, op) with rename/clone sources before their
        destinations (PGTransaction::safe_create_traverse)."""
        emitted = set()
        order = []

        def emit(oid):
            if oid in emitted or oid not in self.op_map:
                return
            op = self.op_map[oid]
            if op.source is not None:
                emit(op.source)
            emitted.add(oid)
            order.append(oid)

        for oid in self.op_map:
            emit(oid)
        return [(oid, self.op_map[oid]) for oid in order]

    def empty(self) -> bool:
        return not self.op_map
