"""One seeded sequence of client ops through a loopback PG.

``run(lb, PGTransaction, cfg)`` drives a ``torch_ec_loopback.Loopback``
through ECBackend's entry points: whole-object writes, reads served from
the device chunk tier, rebuilds from the tier, a bitrot mark the read
path's crc check must turn into a reconstruct-around and a repair,
pipelined read-modify-write overwrites and appends, reads, an EIO mark,
degraded reads with shard OSDs down, rebuilds with the tier off (for a
regenerating code through its helpers' fractions, one with a helper
failing) and a last drain. Every op's inputs come from ``cfg.seed``, so
two runs of it, on the reference's backend and on the port's, make the
same client requests in the same order, and their outputs compare byte
for byte. It imports neither package: the caller passes PGTransaction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Config:
    seed: int = 18
    objects: int = 6
    object_bytes: int = 8192
    low_entropy: bool = False      # values 0..3 (compressible)
    overwrites: int = 12           # of 100-1500 bytes, at random
    appends: int = 3               # of 1 KiB
    ranges: int = 12               # random reads after the overwrites
    down_sets: tuple = ((1,), (1, 2))
    eio: tuple = (1, 2)            # (object, shard) after the overwrites
    repair_fault: tuple | None = None  # (object, shard): EIO in a repair


BITROT = (0, 1)        # (object, shard), before the overwrites
IN_FLIGHT = 4          # overwrites submitted before the first wait
WINDOW = 8             # whole writes in flight at once


def _routes(lb, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in lb.sent.items()
            if v - before.get(k, 0)}


def _extend(model: bytearray, end: int, stripe: int) -> None:
    """The object's logical size is stripe aligned: zeros to the stripe."""
    end = -(-end // stripe) * stripe
    if len(model) < end:
        model.extend(b"\0" * (end - len(model)))


def run(lb, PGTransaction, cfg: Config) -> dict:
    """The outputs: every read and rebuilt shard in order as (label, the
    bytes it returned, the bytes the model or the shard's store held
    then), the messages each step sent, the host model of every object,
    and every shard collection's objects at the end."""
    rng = np.random.default_rng(cfg.seed)
    stripe = lb.primary.backend.sinfo.stripe_width
    oids = ["obj.%d" % i for i in range(cfg.objects)]
    model: dict = {}
    out = {"reads": [], "rebuilt": [], "routes": {}}
    tier = lb.primary.daemon.hbm_tier

    def step(name, fn):
        before = dict(lb.sent)
        fn()
        lb.drain()
        out["routes"][name] = _routes(lb, before)

    def payload(n):
        if cfg.low_entropy:
            return rng.integers(0, 4, n, dtype=np.uint8).tobytes()
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def writes():
        ops = []
        for oid in oids:
            data = payload(cfg.object_bytes)
            t = PGTransaction()
            t.create(oid)
            t.write(oid, 0, data)
            model[oid] = bytearray(data)
            _extend(model[oid], len(data), stripe)
            ops.append(lb.submit_async(t))
            if len(ops) >= WINDOW:
                ops.pop(0).result()
        for op in ops:
            op.result()

    def read_all(label, ranges=0):
        for oid in oids:
            out["reads"].append((label + ":" + oid, lb.read(oid),
                                 bytes(model[oid])))
        for _ in range(ranges):
            oid = oids[int(rng.integers(0, len(oids)))]
            size = len(model[oid])
            off = int(rng.integers(0, size))
            length = int(rng.integers(1, size - off + 1))
            out["reads"].append(("%s:%s[%d:%d]" % (label, oid, off,
                                                   off + length),
                                 lb.read(oid, off, length),
                                 bytes(model[oid][off:off + length])))

    def rebuild(label, oid, shard):
        got = lb.recover(oid, shard)
        want = lb.shard_store(shard).read(lb.cid(shard), oid)
        out["rebuilt"].append(("%s:%s/%d" % (label, oid, shard), got,
                               want))

    def rebuild_all(label):
        for i, oid in enumerate(oids):
            rebuild(label, oid, i % lb.n)

    step("writes", writes)
    if tier is not None:
        lb.primary.daemon.hbm_serve_reads = True
        step("tier_reads", lambda: read_all("tier", 2))
        lb.primary.daemon.hbm_serve_reads = False
        step("tier_rebuild", lambda: rebuild_all("tier"))

    def fault(where, mark):
        obj, shard = where
        oid = oids[obj]
        getattr(lb.shard_store(shard).faults, mark)(lb.cid(shard), oid)
        out["reads"].append(("%s:%s" % (mark, oid), lb.read(oid),
                             bytes(model[oid])))

    step("bitrot", lambda: fault(BITROT, "mark_bitrot"))

    def overwrites():
        ops = []
        for _ in range(cfg.overwrites):
            oid = oids[int(rng.integers(0, len(oids)))]
            length = int(rng.integers(100, 1501))
            off = int(rng.integers(0, len(model[oid]) - length))
            data = payload(length)
            t = PGTransaction()
            t.write(oid, off, data)
            model[oid][off:off + length] = data
            ops.append(lb.submit_async(t))
            if len(ops) >= IN_FLIGHT:
                ops.pop(0).result()
        for op in ops:
            op.result()

    def appends():
        for i in range(cfg.appends):
            oid = oids[i % len(oids)]
            off = len(model[oid])
            data = payload(1024)
            t = PGTransaction()
            t.write(oid, off, data)
            _extend(model[oid], off + len(data), stripe)
            model[oid][off:off + len(data)] = data
            lb.submit(t)

    step("overwrites", overwrites)
    step("appends", appends)
    step("reads", lambda: read_all("read", cfg.ranges))
    step("eio", lambda: fault(cfg.eio, "mark_eio"))
    for down in cfg.down_sets:
        def degraded(down=down):
            lb.mark_down(*down)
            try:
                read_all("down%s" % "".join(map(str, down)), 2)
            finally:
                lb.mark_up(*down)
        step("down" + "".join(map(str, down)), degraded)
    lb.primary.daemon.hbm_tier = None
    step("rebuild", lambda: rebuild_all("rebuild"))
    if cfg.repair_fault is not None:
        def repair_fault():
            obj, shard = cfg.repair_fault
            oid = oids[obj]
            lb.shard_store(shard).faults.mark_eio(lb.cid(shard), oid)
            rebuild("repair_fault", oid, (shard + 1) % lb.n)
            lb.shard_store(shard).faults.clear_eio(lb.cid(shard), oid)
        step("repair_fault", repair_fault)
    lb.primary.daemon.hbm_tier = tier
    out["model"] = {oid: bytes(m) for oid, m in model.items()}
    out["stores"] = {shard: lb.shard_objects(shard)
                     for shard in range(lb.n)}
    out["repaired"] = sorted(lb.repaired)
    out["perf"] = dict(lb.primary.daemon.perf.counts)
    out["logs"] = {o.whoami: o.pg.pg_log.dump() for o in lb.osds}
    return out

