"""Local object store: the data plane's part of the reference's ``store/``.

Port of ``ceph_tpu/store/__init__.py``, reduced to what the OSD's
erasure-coded backend runs on:

  object_store  ObjectStore interface + Transaction op list
                (src/os/ObjectStore.h:68, Transaction :1457)
  faults        FaultSet: EIO and bitrot marks a read must catch
  mem_store     MemStore in-memory backend (src/os/memstore/MemStore.cc)

The file, block (BlueStore-style), BlueFS, KV and K stores are not
ported yet.
"""

from .faults import FaultSet
from .mem_store import MemStore
from .object_store import Collection, ObjectStore, Transaction

__all__ = ["ObjectStore", "Transaction", "Collection", "MemStore",
           "FaultSet"]
