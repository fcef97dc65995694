"""ObjectStore interface + Transaction.

Port of ``ceph_tpu/store/object_store.py``, host code the port keeps its
own copy of.

Role of the reference's ObjectStore (src/os/ObjectStore.h:68): the
per-OSD local storage engine. All mutations travel as a Transaction — an
ordered op list applied atomically (ObjectStore::Transaction, queued via
queue_transactions, ObjectStore.h:1457) with completion callbacks
(on_applied / on_commit) delivered off the IO path.

Objects live in collections (one per PG shard); each object has byte
data, xattrs, and an omap. Transactions here are plain op tuples so any
backend (memory, file, kv) can replay them; the EC/replication backends
build them in generate_transactions.
"""

from __future__ import annotations

__all__ = ["Transaction", "ObjectStore", "Collection"]


class Transaction:
    """Ordered op list; atomic at apply time."""

    def __init__(self):
        self.ops: list[tuple] = []
        self.on_applied: list = []
        self.on_commit: list = []

    def empty(self) -> bool:
        return not self.ops

    def append(self, other: "Transaction") -> None:
        self.ops.extend(other.ops)
        self.on_applied.extend(other.on_applied)
        self.on_commit.extend(other.on_commit)

    # -- collection ops ------------------------------------------------

    def create_collection(self, cid) -> None:
        self.ops.append(("create_collection", cid))

    def remove_collection(self, cid) -> None:
        self.ops.append(("remove_collection", cid))

    # -- object ops ----------------------------------------------------

    def touch(self, cid, oid) -> None:
        self.ops.append(("touch", cid, oid))

    def write(self, cid, oid, offset: int, data) -> None:
        self.ops.append(("write", cid, oid, offset, bytes(data)))

    def zero(self, cid, oid, offset: int, length: int) -> None:
        self.ops.append(("zero", cid, oid, offset, length))

    def truncate(self, cid, oid, size: int) -> None:
        self.ops.append(("truncate", cid, oid, size))

    def remove(self, cid, oid) -> None:
        self.ops.append(("remove", cid, oid))

    def clone(self, cid, src_oid, dst_oid) -> None:
        self.ops.append(("clone", cid, src_oid, dst_oid))

    def collection_move_rename(self, src_cid, src_oid, dst_cid,
                               dst_oid) -> None:
        self.ops.append(("move_rename", src_cid, src_oid, dst_cid, dst_oid))

    # -- attrs / omap --------------------------------------------------

    def setattr(self, cid, oid, name: str, value) -> None:
        self.ops.append(("setattr", cid, oid, name, value))

    def rmattr(self, cid, oid, name: str) -> None:
        self.ops.append(("rmattr", cid, oid, name))

    def omap_setkeys(self, cid, oid, kv: dict) -> None:
        self.ops.append(("omap_setkeys", cid, oid, dict(kv)))

    def omap_rmkeys(self, cid, oid, keys) -> None:
        self.ops.append(("omap_rmkeys", cid, oid, list(keys)))

    # -- completions ---------------------------------------------------

    def register_on_applied(self, cb) -> None:
        if cb:
            self.on_applied.append(cb)

    def register_on_commit(self, cb) -> None:
        if cb:
            self.on_commit.append(cb)


class Collection:
    """One PG shard's object namespace."""

    def __init__(self, cid):
        self.cid = cid
        self.objects: dict = {}


class ObjectStore:
    """Backend interface (the subset the data path exercises)."""

    #: nominal capacity for backends without a real device bound
    #: (MemStore/FileStore/KStore) — `ceph df` percent-used needs a
    #: denominator; BlockStore overrides statfs with the device size
    capacity_bytes = 4 << 30

    def mount(self) -> None: ...

    def umount(self) -> None: ...

    def statfs(self) -> dict:
        """Store-level usage (ObjectStore::statfs): {total, used,
        available} bytes.  Generic implementation walks collections
        and sums object footprints; device-bound backends override
        with allocator-accurate numbers."""
        used = 0
        try:
            for cid in self.list_collections():
                for oid in self.list_objects(cid):
                    st = self.stat(cid, oid)
                    if st is not None:
                        used += st.get("size", 0)
        except Exception:
            pass
        total = max(self.capacity_bytes, used)
        return {"total": total, "used": used,
                "available": total - used}

    def queue_transaction(self, txn: Transaction) -> None:
        raise NotImplementedError

    def read(self, cid, oid, offset: int = 0, length: int = 0) -> bytes:
        raise NotImplementedError

    def stat(self, cid, oid) -> dict | None:
        raise NotImplementedError

    def getattr(self, cid, oid, name: str):
        raise NotImplementedError

    def getattrs(self, cid, oid) -> dict:
        """Full xattr set (ObjectStore::getattrs): recovery pushes must
        carry EVERY xattr — snapset, whiteout, user attrs — or the
        recovered object silently loses state."""
        raise NotImplementedError

    def omap_get(self, cid, oid) -> dict:
        raise NotImplementedError

    def list_objects(self, cid) -> list:
        raise NotImplementedError

    def list_collections(self) -> list:
        raise NotImplementedError
