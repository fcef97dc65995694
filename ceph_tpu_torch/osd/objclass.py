"""Object classes: in-OSD methods executed next to the data.

Port of ``ceph_tpu/osd/objclass.py``, host code the port keeps its own
copy of. Rendition of the reference's cls/objclass subsystem
(src/objclass/ + src/cls/): plugins register named
classes whose methods run inside the primary OSD against one object,
invoked by clients through the `exec` op. Methods declare RD/WR flags;
a WR method's mutations are staged on a method context and committed
as one transaction.

Per the reference's design, classes are unavailable on erasure-coded
pools: cls methods need synchronous local reads and ECBackend's
objects_read_sync returns -EOPNOTSUPP
(doc/dev/osd_internals/erasure_coding/ecbackend.rst:79-83, enforced in
PG.do_op here).

Built-ins mirror reference classes: `hello` (src/cls/hello/),
`lock` (src/cls/lock/ advisory locks), `refcount`
(src/cls/refcount/).
"""

from __future__ import annotations

import threading
import time

from .. import encoding

__all__ = ["ClassHandler", "MethodContext", "CLS_METHOD_RD",
           "CLS_METHOD_WR"]

CLS_METHOD_RD = 1
CLS_METHOD_WR = 2


class MethodContext:
    """cls_method_context_t: the object view a method runs against.

    Reads come straight from the local store; writes stage into a
    PGTransaction the PG commits after the method returns success.
    """

    def __init__(self, pg, oid):
        from .pg_transaction import PGTransaction
        self.pg = pg
        self.oid = oid
        self.txn = PGTransaction()
        self.wrote = False
        self.removed = False   # final state is "object gone"

    # -- reads ---------------------------------------------------------

    def _cid(self):
        return self.pg.cid_of_shard(self.pg.my_shard())

    def read(self, offset: int = 0, length: int = 0) -> bytes | None:
        try:
            return self.pg.store.read(self._cid(), self.oid, offset,
                                      length)
        except KeyError:
            return None

    def stat(self):
        size = self.pg._object_size(self.oid)
        return None if size is None else {"size": size}

    def getxattr(self, name: str):
        try:
            return self.pg.store.getattr(self._cid(), self.oid, name)
        except KeyError:
            return None

    def omap_get(self) -> dict:
        try:
            return self.pg.store.omap_get(self._cid(), self.oid)
        except KeyError:
            return {}

    # -- staged writes --------------------------------------------------

    def create(self) -> None:
        self.wrote = True
        self.removed = False
        self.txn.create(self.oid)

    def write(self, offset: int, data: bytes) -> None:
        self.wrote = True
        self.removed = False
        self.txn.write(self.oid, offset, data)

    def setxattr(self, name: str, value: bytes) -> None:
        self.wrote = True
        self.removed = False
        self.txn.setattr(self.oid, name, value)

    def rmxattr(self, name: str) -> None:
        self.wrote = True
        self.removed = False
        self.txn.rmattr(self.oid, name)

    def omap_set(self, kv: dict) -> None:
        self.wrote = True
        self.removed = False
        self.txn.omap_setkeys(self.oid, kv)

    def remove(self) -> None:
        self.wrote = True
        self.removed = True
        self.txn.remove(self.oid)


class _Method:
    __slots__ = ("name", "flags", "fn")

    def __init__(self, name, flags, fn):
        self.name = name
        self.flags = flags
        self.fn = fn


class _Class:
    def __init__(self, name: str):
        self.name = name
        self.methods: dict[str, _Method] = {}

    def register_method(self, name: str, flags: int, fn) -> None:
        if name in self.methods:
            raise ValueError("method %s.%s already registered"
                             % (self.name, name))
        self.methods[name] = _Method(name, flags, fn)


class ClassHandler:
    """Process-wide class registry (reference ClassHandler singleton)."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self.classes: dict[str, _Class] = {}

    @classmethod
    def instance(cls) -> "ClassHandler":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    # fully build (builtins included) BEFORE publishing,
                    # so a concurrent first caller never sees an empty
                    # registry
                    inst = cls()
                    _register_builtins(inst)
                    cls._instance = inst
        return cls._instance

    def register_class(self, name: str) -> _Class:
        c = self.classes.get(name)
        if c is None:
            c = self.classes[name] = _Class(name)
        return c

    def get_method(self, cls_name: str, method: str) -> _Method | None:
        c = self.classes.get(cls_name)
        return c.methods.get(method) if c else None


# ---------------------------------------------------------------------------
# built-in classes


def _register_builtins(handler: ClassHandler) -> None:
    # -- hello (src/cls/hello/cls_hello.cc) -----------------------------
    hello = handler.register_class("hello")

    def say_hello(hctx, indata: bytes):
        name = indata.decode() if indata else "world"
        return 0, ("Hello, %s!" % name).encode()

    def record_hello(hctx, indata: bytes):
        if hctx.getxattr("hello.greeted") is not None:
            return -17, b""  # EEXIST: only greet once
        hctx.create()
        hctx.setxattr("hello.greeted", indata or b"world")
        return 0, b""

    hello.register_method("say_hello", CLS_METHOD_RD, say_hello)
    hello.register_method("record_hello",
                          CLS_METHOD_RD | CLS_METHOD_WR, record_hello)

    # -- lock (src/cls/lock/: advisory object locks) --------------------
    lock_cls = handler.register_class("lock")
    LOCK_XATTR = "lock.%s"

    def _load_lock(hctx, name):
        blob = hctx.getxattr(LOCK_XATTR % name)
        return encoding.decode_any(blob) if blob else {"type": None,
                                                "lockers": {}}

    def _prune_expired(st, now):
        # cls_lock lock duration semantics (cls_lock_types.h): a locker
        # with a nonzero duration self-expires, so a crashed holder
        # cannot wedge the object forever
        dead = [c for c, info in st["lockers"].items()
                if info.get("expires") and now > info["expires"]]
        for c in dead:
            del st["lockers"][c]
        if not st["lockers"]:
            st["type"] = None

    def lock_lock(hctx, indata: bytes):
        # {name, cookie, type: exclusive|shared, duration: secs (0=forever)}
        req = encoding.decode_any(indata)
        now = time.time()
        st = _load_lock(hctx, req["name"])
        _prune_expired(st, now)
        if st["lockers"]:
            if st["type"] == "exclusive" or req["type"] == "exclusive":
                if req["cookie"] not in st["lockers"]:
                    return -16, b""  # EBUSY
        duration = float(req.get("duration") or 0.0)
        st["type"] = req["type"]
        st["lockers"][req["cookie"]] = {
            "acquired": now,
            "expires": now + duration if duration else None}
        hctx.setxattr(LOCK_XATTR % req["name"], encoding.encode_any(st))
        return 0, b""

    def lock_break(hctx, indata: bytes):
        # {name, cookie}: forcibly evict another client's locker
        # (cls_lock break_lock, the admin/recovery path)
        req = encoding.decode_any(indata)
        st = _load_lock(hctx, req["name"])
        if req["cookie"] not in st["lockers"]:
            return -2, b""           # ENOENT
        del st["lockers"][req["cookie"]]
        if not st["lockers"]:
            st["type"] = None
        hctx.setxattr(LOCK_XATTR % req["name"], encoding.encode_any(st))
        return 0, b""

    def lock_unlock(hctx, indata: bytes):
        req = encoding.decode_any(indata)   # {name, cookie}
        st = _load_lock(hctx, req["name"])
        if req["cookie"] not in st["lockers"]:
            return -2, b""           # ENOENT
        del st["lockers"][req["cookie"]]
        if not st["lockers"]:
            st["type"] = None
        hctx.setxattr(LOCK_XATTR % req["name"], encoding.encode_any(st))
        return 0, b""

    def lock_get_info(hctx, indata: bytes):
        req = encoding.decode_any(indata)   # {name}
        return 0, encoding.encode_any(_load_lock(hctx, req["name"]))

    lock_cls.register_method("lock", CLS_METHOD_RD | CLS_METHOD_WR,
                             lock_lock)
    lock_cls.register_method("unlock", CLS_METHOD_RD | CLS_METHOD_WR,
                             lock_unlock)
    lock_cls.register_method("break_lock", CLS_METHOD_RD | CLS_METHOD_WR,
                             lock_break)
    lock_cls.register_method("get_info", CLS_METHOD_RD, lock_get_info)

    # -- refcount (src/cls/refcount/) -----------------------------------
    refc = handler.register_class("refcount")
    REF_XATTR = "refcount.refs"

    def _load_refs(hctx):
        blob = hctx.getxattr(REF_XATTR)
        return encoding.decode_any(blob) if blob else set()

    def ref_get(hctx, indata: bytes):
        tag = indata.decode()
        refs = _load_refs(hctx)
        refs.add(tag)
        hctx.setxattr(REF_XATTR, encoding.encode_any(refs))
        return 0, b""

    def ref_put(hctx, indata: bytes):
        tag = indata.decode()
        refs = _load_refs(hctx)
        refs.discard(tag)
        if refs:
            hctx.setxattr(REF_XATTR, encoding.encode_any(refs))
        else:
            # last reference dropped: the object goes away
            hctx.remove()
        return 0, b""

    def ref_read(hctx, indata: bytes):
        return 0, encoding.encode_any(sorted(_load_refs(hctx)))

    refc.register_method("get", CLS_METHOD_RD | CLS_METHOD_WR, ref_get)
    refc.register_method("put", CLS_METHOD_RD | CLS_METHOD_WR, ref_put)
    refc.register_method("read", CLS_METHOD_RD, ref_read)
