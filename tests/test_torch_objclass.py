"""The port's object classes against the reference's.

Every built-in method (``hello``, ``lock``, ``refcount``) runs in both
packages against the same object in a store of each package's own, one
seeded sequence of calls; each call's result and output, and the
mutations it staged (the ``PGTransaction`` each commits), are the same.
The clock the lock class stamps is pinned.
"""

import time

from ceph_tpu import encoding as ref_enc
from ceph_tpu.osd import objclass as ref_cls
from ceph_tpu.store import MemStore as RefStore, Transaction as RefTxn
from ceph_tpu_torch import encoding as port_enc
from ceph_tpu_torch.osd import objclass as port_cls
from ceph_tpu_torch.store import MemStore as PortStore
from ceph_tpu_torch.store import Transaction as PortTxn

CID = ("pg", "1.0", -1)


class _PG:
    """What a MethodContext reads of its PG."""

    def __init__(self, store):
        self.store = store

    def cid_of_shard(self, shard):
        return CID

    def my_shard(self):
        return -1

    def _object_size(self, oid):
        st = self.store.stat(CID, oid)
        return None if st is None else st["size"]


def calls(enc) -> list:
    lock = enc.encode_any
    return [
        ("hello", "say_hello", b""),
        ("hello", "say_hello", b"osd"),
        ("hello", "record_hello", b"first"),
        ("hello", "record_hello", b"second"),
        ("lock", "lock", lock({"name": "l", "cookie": "c1",
                               "type": "exclusive", "duration": 0})),
        ("lock", "lock", lock({"name": "l", "cookie": "c2",
                               "type": "exclusive"})),
        ("lock", "get_info", lock({"name": "l"})),
        ("lock", "break_lock", lock({"name": "l", "cookie": "c1"})),
        ("lock", "lock", lock({"name": "s", "cookie": "a",
                               "type": "shared", "duration": 30})),
        ("lock", "lock", lock({"name": "s", "cookie": "b",
                               "type": "shared"})),
        ("lock", "unlock", lock({"name": "s", "cookie": "zz"})),
        ("lock", "unlock", lock({"name": "s", "cookie": "a"})),
        ("lock", "get_info", lock({"name": "s"})),
        ("refcount", "get", b"t1"),
        ("refcount", "read", b""),
        ("refcount", "put", b"t1"),
        ("refcount", "read", b""),
    ]


def run(cls, enc, Store, Txn) -> list:
    store = Store()
    store.mount()
    txn = Txn()
    txn.create_collection(CID)
    txn.touch(CID, "obj")
    txn.write(CID, "obj", 0, b"payload")
    store.queue_transaction(txn)
    pg = _PG(store)
    handler = cls.ClassHandler.instance()
    out = []
    for cls_name, method, indata in calls(enc):
        m = handler.get_method(cls_name, method)
        hctx = cls.MethodContext(pg, "obj")
        ret, data = m.fn(hctx, indata)
        staged = {oid: (op.init_type, [tuple(u) for u in op.buffer_updates],
                        dict(op.attr_updates), dict(op.omap_updates),
                        op.is_delete())
                  for oid, op in hctx.txn.op_map.items()}
        out.append((cls_name, method, m.flags, ret, data, hctx.wrote,
                    hctx.removed, staged))
        # commit what the method staged, as the PG does after success
        if ret == 0 and hctx.wrote:
            t = Txn()
            for oid, (_, ups, attrs, omap, deleted) in staged.items():
                if deleted:
                    t.remove(CID, oid)
                    continue
                t.touch(CID, oid)
                for name, value in attrs.items():
                    if value is None:
                        t.rmattr(CID, oid, name)
                    else:
                        t.setattr(CID, oid, name, value)
            store.queue_transaction(t)
    return out


def test_builtin_methods_equal_the_reference(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    ref = run(ref_cls, ref_enc, RefStore, RefTxn)
    port = run(port_cls, port_enc, PortStore, PortTxn)
    assert len(port) == len(ref)
    for a, b in zip(ref, port):
        assert b == a, a[:2]


def test_the_registries_list_the_same_methods():
    ref = ref_cls.ClassHandler.instance()
    port = port_cls.ClassHandler.instance()
    assert sorted(port.classes) == sorted(ref.classes)
    for name, c in ref.classes.items():
        assert {m: (x.flags) for m, x in port.classes[name].methods.items()} \
            == {m: x.flags for m, x in c.methods.items()}


def test_flag_values_equal_the_reference():
    assert (port_cls.CLS_METHOD_RD, port_cls.CLS_METHOD_WR) == \
        (ref_cls.CLS_METHOD_RD, ref_cls.CLS_METHOD_WR)
