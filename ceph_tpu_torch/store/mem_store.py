"""In-memory ObjectStore.

Port of ``ceph_tpu/store/mem_store.py``, host code the port keeps its
own copy of.

Role of the reference's MemStore (src/os/memstore/MemStore.cc): the
store used when durability is mocked — unit tests, the in-process
cluster harness, fault-injection runs. Transactions apply atomically
under one lock; completions run inline or via a Finisher when provided
(the reference queues them on the OSD's finishers so callbacks never run
in the IO path's lock scope).

Fault injection rides a FaultSet (store/faults.py): EIO and silent
bitrot on marked or hash-selected objects (objectstore_inject_eio /
objectstore_inject_bitrot knobs; inject_read_error kept as the
historical EIO-mark spelling)."""

from __future__ import annotations

import threading
import time

from .faults import FaultSet
from .object_store import Collection, ObjectStore, Transaction

__all__ = ["MemStore"]


class _Object:
    __slots__ = ("data", "xattrs", "omap")

    def __init__(self):
        self.data = bytearray()
        self.xattrs: dict = {}
        self.omap: dict = {}

    def clone(self) -> "_Object":
        o = _Object()
        o.data = bytearray(self.data)
        o.xattrs = dict(self.xattrs)
        o.omap = dict(self.omap)
        return o


class MemStore(ObjectStore):
    # object-record factory, overridable/reusable by derived stores
    # (FileStore rebuilds records from checkpoint files through this)
    make_object = staticmethod(_Object)

    def __init__(self, finisher=None):
        self._lock = threading.RLock()
        self._colls: dict = {}
        self._finisher = finisher
        self.faults = FaultSet()
        self.mounted = False

    # -- lifecycle -----------------------------------------------------

    def mount(self) -> None:
        self.mounted = True

    def umount(self) -> None:
        self.mounted = False

    # -- fault injection ----------------------------------------------

    def inject_read_error(self, cid, oid) -> None:
        with self._lock:
            self.faults.mark_eio(cid, oid)

    def clear_read_error(self, cid, oid) -> None:
        with self._lock:
            self.faults.clear_eio(cid, oid)

    # -- mutation ------------------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        # tracing: a txn carrying a span (set by the PG backends) gets
        # a store_apply child — the in-memory analog of BlockStore's
        # wal_append/bluefs_fsync/deferred_apply phase spans
        trace = getattr(txn, "trace", None)
        t0 = time.monotonic() if trace is not None \
            and trace.valid() else None
        with self._lock:
            for op in txn.ops:
                self._apply(op)
        if t0 is not None:
            trace.child_interval("store_apply", t0, time.monotonic(),
                                 ops=len(txn.ops))
        for cb in txn.on_applied:
            self._complete(cb)
        for cb in txn.on_commit:
            self._complete(cb)

    def _complete(self, cb) -> None:
        if self._finisher is not None:
            self._finisher.queue(cb)
        else:
            cb()

    def _coll(self, cid) -> Collection:
        coll = self._colls.get(cid)
        if coll is None:
            raise KeyError("no collection %r" % (cid,))
        return coll

    def _obj(self, cid, oid, create: bool = False) -> _Object:
        coll = self._coll(cid)
        obj = coll.objects.get(oid)
        if obj is None:
            if not create:
                raise KeyError("no object %r in %r" % (oid, cid))
            obj = coll.objects[oid] = _Object()
        return obj

    # op kinds whose (cid, oid) rewrite clears explicit fault marks
    # (see FaultSet.on_write: a repair rewrite heals the bad sector)
    _REMAP_KINDS = frozenset(("write", "zero", "truncate", "remove",
                              "clone_data"))

    def _apply(self, op: tuple) -> None:
        kind = op[0]
        if kind in self._REMAP_KINDS:
            self.faults.on_write(op[1], op[2])
        if kind == "create_collection":
            self._colls.setdefault(op[1], Collection(op[1]))
        elif kind == "remove_collection":
            self._colls.pop(op[1], None)
        elif kind == "touch":
            self._obj(op[1], op[2], create=True)
        elif kind == "write":
            _, cid, oid, offset, data = op
            obj = self._obj(cid, oid, create=True)
            end = offset + len(data)
            if len(obj.data) < end:
                obj.data.extend(b"\0" * (end - len(obj.data)))
            obj.data[offset:end] = data
        elif kind == "zero":
            _, cid, oid, offset, length = op
            obj = self._obj(cid, oid, create=True)
            end = offset + length
            if len(obj.data) < end:
                obj.data.extend(b"\0" * (end - len(obj.data)))
            obj.data[offset:end] = b"\0" * length
        elif kind == "truncate":
            _, cid, oid, size = op
            obj = self._obj(cid, oid, create=True)
            if len(obj.data) > size:
                del obj.data[size:]
            else:
                obj.data.extend(b"\0" * (size - len(obj.data)))
        elif kind == "remove":
            self._coll(op[1]).objects.pop(op[2], None)
        elif kind == "clone":
            _, cid, src, dst = op
            self._coll(cid).objects[dst] = self._obj(cid, src).clone()
        elif kind == "clone_data":
            # content-captured clone (FileStore journals these so replay
            # is idempotent: the captured bytes, not the live source)
            _, cid, dst, data, xattrs, omap = op
            obj = self._obj(cid, dst, create=True)
            obj.data = bytearray(data)
            obj.xattrs = dict(xattrs)
            obj.omap = dict(omap)
        elif kind == "move_rename":
            _, src_cid, src_oid, dst_cid, dst_oid = op
            obj = self._coll(src_cid).objects.pop(src_oid)
            self._coll(dst_cid).objects[dst_oid] = obj
        elif kind == "move_data":
            # content-captured move_rename (idempotent on replay: a
            # missing source means the move already happened)
            _, src_cid, src_oid, dst_cid, dst_oid, data, xattrs, omap = op
            src_coll = self._colls.get(src_cid)
            if src_coll is not None:
                src_coll.objects.pop(src_oid, None)
            obj = self._obj(dst_cid, dst_oid, create=True)
            obj.data = bytearray(data)
            obj.xattrs = dict(xattrs)
            obj.omap = dict(omap)
        elif kind == "setattr":
            _, cid, oid, name, value = op
            self._obj(cid, oid, create=True).xattrs[name] = value
        elif kind == "rmattr":
            self._obj(op[1], op[2]).xattrs.pop(op[3], None)
        elif kind == "omap_setkeys":
            self._obj(op[1], op[2], create=True).omap.update(op[3])
        elif kind == "omap_rmkeys":
            omap = self._obj(op[1], op[2]).omap
            for key in op[3]:
                omap.pop(key, None)
        else:
            raise ValueError("unknown op %r" % kind)

    # -- reads ---------------------------------------------------------

    def read(self, cid, oid, offset: int = 0, length: int = 0) -> bytes:
        with self._lock:
            self.faults.check_eio(cid, oid)
            obj = self._obj(cid, oid)
            if length == 0:
                length = len(obj.data) - offset
            data = bytes(obj.data[offset:offset + length])
            return self.faults.corrupt(cid, oid, offset, data)

    def stat(self, cid, oid) -> dict | None:
        with self._lock:
            coll = self._colls.get(cid)
            obj = coll.objects.get(oid) if coll else None
            return {"size": len(obj.data)} if obj is not None else None

    def exists(self, cid, oid) -> bool:
        return self.stat(cid, oid) is not None

    def getattr(self, cid, oid, name: str):
        with self._lock:
            return self._obj(cid, oid).xattrs.get(name)

    def getattrs(self, cid, oid) -> dict:
        with self._lock:
            return dict(self._obj(cid, oid).xattrs)

    def omap_get(self, cid, oid) -> dict:
        with self._lock:
            return dict(self._obj(cid, oid).omap)

    def list_objects(self, cid) -> list:
        with self._lock:
            coll = self._colls.get(cid)
            return sorted(coll.objects) if coll else []

    def list_collections(self) -> list:
        with self._lock:
            return sorted(self._colls)
