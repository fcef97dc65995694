"""Deterministic store fault injection.

Port of ``ceph_tpu/store/faults.py``, host code the port keeps its own
copy of.

Role of the reference's objectstore failure-injection knobs
(src/common/options.cc objectstore_debug_throw_on_failed_txc,
filestore_debug_inject_read_err and the test hooks
qa/standalone/scrub + test-erasure-eio.sh drive): make the local
store LIE — return EIO, or silently flipped bytes — so the layers
above (EC reconstruct-on-read, deep scrub, recovery) are exercised
against an actually bad disk instead of only against clean state.
Styled after the messenger's `ms_inject_socket_failures`
(msg/messenger.py): config knobs select 1-in-N victims, a seed makes
every run replayable.

Two fault sources compose:

  explicit marks   mark_eio()/mark_bitrot() poison one (cid, oid).
                   A rewrite of the object CLEARS its marks (a repair
                   push rewriting the shard "remaps the sector", like
                   a real disk completing a successful write) — this
                   is what lets scrub-repair tests observe the heal.
  conf selection   objectstore_inject_eio / objectstore_inject_bitrot
                   = N select 1-in-N objects by seeded hash. Hash-
                   selected faults model a consistently lying disk:
                   the SAME objects fail on every read, every run with
                   the same seed, and a rewrite does not cure them.

Bitrot flips one byte at a deterministic position, so repeated reads
return the same wrong bytes — corruption, not noise.
"""

from __future__ import annotations

import hashlib

__all__ = ["FaultSet"]


class FaultSet:
    def __init__(self, seed: int = 0, eio_one_in: int = 0,
                 bitrot_one_in: int = 0):
        self.seed = seed
        self.eio_one_in = eio_one_in
        self.bitrot_one_in = bitrot_one_in
        self._eio: set = set()        # explicit (cid, oid) EIO marks
        self._bitrot: set = set()     # explicit (cid, oid) bitrot marks
        self._trips: dict = {}        # trip point -> remaining count

    def configure(self, conf) -> None:
        """Adopt the objectstore_inject_* knobs from a Context conf
        (missing keys keep current values — stores built without a
        conf stay fault-free)."""
        for attr, key in (("seed", "objectstore_fault_seed"),
                          ("eio_one_in", "objectstore_inject_eio"),
                          ("bitrot_one_in", "objectstore_inject_bitrot")):
            try:
                setattr(self, attr, int(conf.get_val(key)))
            except (KeyError, TypeError, ValueError):
                pass

    # -- explicit marks ------------------------------------------------

    def mark_eio(self, cid, oid) -> None:
        self._eio.add((cid, oid))

    def clear_eio(self, cid, oid) -> None:
        self._eio.discard((cid, oid))

    def mark_bitrot(self, cid, oid) -> None:
        self._bitrot.add((cid, oid))

    def clear_bitrot(self, cid, oid) -> None:
        self._bitrot.discard((cid, oid))

    def clear_all(self) -> None:
        self._eio.clear()
        self._bitrot.clear()

    def on_write(self, cid, oid) -> None:
        """A (re)write of the object clears its explicit marks — the
        repair path's rewrite heals the injected fault, like a disk
        remapping a bad sector on write. Hash-selected faults persist
        (that disk keeps lying)."""
        key = (cid, oid)
        self._eio.discard(key)
        self._bitrot.discard(key)

    # -- trip points (write-path EIO at named code sites) --------------

    def arm_trip(self, point: str, count: int = 1) -> None:
        """The next `count` passages of the named code site raise EIO —
        the device failing mid-operation (e.g. mid BlueFS journal
        compaction), not just on reads. Sites declare themselves by
        calling check_trip()."""
        self._trips[point] = count

    def check_trip(self, point: str) -> None:
        n = self._trips.get(point, 0)
        if n > 0:
            if n == 1:
                del self._trips[point]
            else:
                self._trips[point] = n - 1
            raise OSError(5, "injected EIO at %s" % point)

    # -- selection -----------------------------------------------------

    def _hash(self, cid, oid) -> int:
        h = hashlib.sha1(repr((self.seed, cid, oid)).encode()).digest()
        return int.from_bytes(h[:8], "little")

    def empty(self) -> bool:
        return not (self._eio or self._bitrot
                    or self.eio_one_in or self.bitrot_one_in)

    # -- read-path hooks -----------------------------------------------

    def check_eio(self, cid, oid) -> None:
        """Raise OSError(EIO) when this object is a victim."""
        if (cid, oid) in self._eio:
            raise OSError(5, "injected EIO on %r/%r" % (cid, oid))
        if self.eio_one_in > 0 and \
                self._hash(cid, oid) % self.eio_one_in == 0:
            raise OSError(5, "injected EIO (1-in-%d) on %r/%r"
                          % (self.eio_one_in, cid, oid))

    def corrupt(self, cid, oid, offset: int, data: bytes) -> bytes:
        """Return the read bytes with injected bitrot applied (the
        silent-corruption path: no error, wrong data)."""
        if not data:
            return data
        rotten = (cid, oid) in self._bitrot
        if not rotten and self.bitrot_one_in > 0:
            # salt the hash so the eio and bitrot populations differ
            h = hashlib.sha1(repr(
                ("rot", self.seed, cid, oid)).encode()).digest()
            rotten = int.from_bytes(h[:8], "little") \
                % self.bitrot_one_in == 0
        if not rotten:
            return data
        pos = self._hash(cid, oid) % len(data)
        out = bytearray(data)
        out[pos] ^= 0xFF
        return bytes(out)
