"""Cache tiering: the names a PG reads.

Port of ``ceph_tpu/osd/tiering.py``, in part: the dirty-bit xattr and
the hit-set object prefix (:66-67), which the PG's writes and its
``list`` op read. ``PGTier`` (promote, proxy, flush, evict and the tier
agent) does its base-pool IO through the RADOS client and waits for the
client's slice; until then the port's PG refuses a cache-tier op with
``NotImplementedError`` (``ceph_tpu_torch/osd/pg.py`` ``PG._tier``).
"""

from __future__ import annotations

__all__ = ["DIRTY_ATTR", "HITSET_PREFIX"]

DIRTY_ATTR = "_dirty"
HITSET_PREFIX = "_hitset_"
