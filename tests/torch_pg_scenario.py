"""One seeded PG scenario, run through either package's PGs.

``run(cluster, cfg)`` drives a ``tests/torch_pg_loopback.Cluster`` through
the PG's entry points only (``do_op``, map epochs, ``scrub_pg``):

1. a pool (erasure with ``cfg.profile``, else replicated of
   ``cfg.size``), then whole-object writes, overwrites at random offsets
   (read-modify-write on an erasure pool), appends, xattrs set and
   removed, omap keys set and removed, removes, watch/notify,
   object-class calls, and reads;
2. one OSD down: the PGs peer around it, writes land degraded, every
   object reads back; the OSD up (back from a partition): the PGs peer
   and recover from their logs; writes under a snapshot context (each
   head's pre-write bytes kept as a clone), snap reads and
   ``list_snaps``; another OSD out: the PGs remap and bring their new
   acting members up to date;
3. bitrot on shards, then a deep scrub with repair of every PG and a
   second deep scrub;
4. every object read back, every PG's stats.

The ops of one PG run one after another, the PGs side by side
(``Cluster.run_lanes``), so every PG sees its ops in one order in either
package. Returns every reply, every scrub's stats, every PG's
``get_stats()`` and acting set, and every OSD's collections (object
bytes, xattrs, omap, the PG meta object's log rows). The model (the bytes
each object should hold) rides along, and every read is checked against
it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

EC_POOL = 1
PG_NUM = 4
STRIPE_UNIT = 1024
OBJECT_BYTES = 65536
OVERWRITES = 8
APPENDS = 4
REMOVES = 2
SNAP_OBJECTS = 2
DEGRADED_WRITES = 4
DOWN, OUT = 1, 6                 # the OSD marked down then up; out


@dataclasses.dataclass
class Config:
    seed: int = 20
    n_osds: int = 8
    profile: dict | None = None      # erasure pool; None: replicated
    size: int = 3                    # replicated pool size
    objects: int = 12
    # bitrot: (n, shard position): the n-th object written whole and
    # never touched since, whose hinfo still holds its shards' crcs
    bitrot: tuple = ((0, 1), (1, 2))


def oid_of(i: int) -> str:
    return "obj.%03d" % i


def stripe_width(codec, stripe_unit: int) -> int:
    """ceph_tpu/mon/osd_monitor.py:673-677."""
    k = codec.get_data_chunk_count()
    return k * codec.get_chunk_size(stripe_unit * k)


def create_pool(cluster, cfg: Config, codec=None) -> None:
    if cfg.profile is None:
        cluster.create_pool(EC_POOL, "rep", size=cfg.size,
                            min_size=max(1, cfg.size - 1), pg_num=PG_NUM)
        return
    k = codec.get_data_chunk_count()
    cluster.create_pool(EC_POOL, "ecpool", size=codec.get_chunk_count(),
                        min_size=k + 1, pg_num=PG_NUM, profile=cfg.profile,
                        stripe_width=stripe_width(codec, STRIPE_UNIT))


class _Run:
    def __init__(self, cluster, cfg):
        self.cluster = cluster
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.model: dict = {}            # oid -> bytearray (None: gone)
        self.whole: list = []            # written whole, untouched since
        self.clones: dict = {}           # clone oid -> its bytes
        self.replies: list = []          # (label, result, data)

    def data(self, n: int) -> bytes:
        return self.rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def lanes(self, label, ops) -> list:
        """Run [(oid, op vector, kw)] and keep every reply."""
        out = self.cluster.run_lanes(
            [(EC_POOL, oid, vec, kw) for oid, vec, kw in ops])
        for (oid, vec, _), (result, data) in zip(ops, out):
            self.replies.append(("%s %s %s" % (label, oid, vec[0][0]),
                                 result, data))
        return out

    def expect_ok(self, label, out) -> None:
        for i, (result, _) in enumerate(out):
            assert result == 0, "%s #%d: result %d" % (label, i, result)

    def live(self) -> list:
        return sorted(o for o, d in self.model.items() if d is not None)

    def read_all(self, label) -> None:
        oids = self.live()
        out = self.lanes(label, [(o, [("read", 0, 0)], {}) for o in oids])
        for oid, (result, data) in zip(oids, out):
            assert result == 0, "%s: read %s: %d" % (label, oid, result)
            assert bytes(data) == bytes(self.model[oid]), \
                "%s: %s differs from the model" % (label, oid)

    def writes(self, label, idx) -> None:
        ops = []
        for i in idx:
            oid = oid_of(i)
            data = self.data(OBJECT_BYTES)
            self.model[oid] = bytearray(data)
            self.whole.append(oid)
            ops.append((oid, [("writefull", data)], {}))
        self.expect_ok(label, self.lanes(label, ops))

    def touch(self, oid) -> None:
        if oid in self.whole:
            self.whole.remove(oid)

    def overwrites(self, label, n) -> None:
        ops = []
        for _ in range(n):
            oid = self.live()[int(self.rng.integers(len(self.live())))]
            cur = self.model[oid]
            length = int(self.rng.integers(1, 8)) * 512 + \
                int(self.rng.integers(0, 512))
            off = int(self.rng.integers(0, max(1, len(cur) - length)))
            data = self.data(length)
            cur[off:off + length] = data
            self.touch(oid)
            ops.append((oid, [("write", off, data)], {}))
        self.expect_ok(label, self.lanes(label, ops))


def snapshots(r, cfg) -> None:
    """Writes under snapshot 1's context (each head cloned in the same
    op), snap reads of the clones, list_snaps."""
    snapc = (1, (1,))
    snapped = [oid_of(cfg.objects - REMOVES - 1 - i)
               for i in range(SNAP_OBJECTS)]
    before = {oid: bytes(r.model[oid]) for oid in snapped}
    r.clones.update({"%s@%d" % (oid, snapc[0]): data
                     for oid, data in before.items()})
    ops = []
    for oid in snapped:
        data = r.data(OBJECT_BYTES // 2)
        r.model[oid][:len(data)] = data
        r.touch(oid)
        ops.append((oid, [("write", 0, data)], {"snapc": snapc}))
    r.expect_ok("snap write", r.lanes("snap write", ops))
    out = r.lanes("snap read", [(o, [("read", 0, 0)], {"snap": 1})
                                for o in snapped])
    for oid, (result, data) in zip(snapped, out):
        assert result == 0 and bytes(data) == before[oid], oid
    r.expect_ok("list_snaps", r.lanes(
        "list_snaps", [(o, [("list_snaps",)], {}) for o in snapped]))


def store_mismatches(cluster, model: dict, encode, pool_id=EC_POOL) -> list:
    """Where the acting OSDs' stores differ from the model: each
    object's shard streams (``encode(bytes)`` -> the n shard streams of
    an erasure pool's object, None for a replicated pool, whose every
    acting member holds the bytes) in the collection of its shard on the
    OSD acting for that shard."""
    bad = []
    for oid, data in sorted(model.items()):
        head = oid.split("@")[0]
        pgid = cluster.pgid_of(pool_id, head)
        acting, _ = cluster.acting(pgid)
        want = encode(data) if encode is not None else None
        for pos, osd in enumerate(acting):
            shard = pos if want is not None else -1
            try:
                got = cluster.daemons[osd].store.read(
                    ("pg", str(pgid), shard), oid)
            except KeyError:
                got = None
            if got != (want[pos] if want is not None else data):
                bad.append((oid, pos, osd))
    return bad


def run(cluster, cfg: Config, codec=None, encode=None) -> dict:
    """The scenario on ``cluster``; ``codec`` is a codec of the pool's
    profile (the stripe width's source) for an erasure pool, ``encode``
    what ``store_mismatches`` holds the stores against."""
    r = _Run(cluster, cfg)
    scrubs: dict = {}
    create_pool(cluster, cfg, codec)
    cluster.drain()

    # -- 1. client ops -------------------------------------------------
    r.writes("write", range(cfg.objects))
    r.overwrites("overwrite", OVERWRITES)
    ops = []
    for i in range(APPENDS):
        oid = oid_of(i)
        data = r.data(1000 + 333 * i)
        r.model[oid] += data
        r.touch(oid)
        ops.append((oid, [("append", data)], {}))
    r.expect_ok("append", r.lanes("append", ops))
    ops = [(oid_of(1), [("setxattr", "user.a", b"alpha")], {}),
           (oid_of(2), [("setxattr", "user.b", b"beta"),
                        ("setxattr", "user.c", b"gamma")], {}),
           (oid_of(2), [("rmxattr", "user.c")], {}),
           (oid_of(3), [("omap_set", {"k1": b"v1", "k2": b"v2"})], {}),
           (oid_of(4), [("omap_set", {"a": b"1", "b": b"2"})], {}),
           (oid_of(4), [("omap_rm", ["a"])], {})]
    r.expect_ok("metadata", r.lanes("metadata", ops))
    gone = [oid_of(cfg.objects - 1 - i) for i in range(REMOVES)]
    for oid in gone:
        r.model[oid] = None
        r.touch(oid)
    r.expect_ok("remove", r.lanes("remove", [(o, [("remove",)], {})
                                             for o in gone]))
    # watch/notify: client 2 watches, client 1 notifies
    cluster.watcher(2, b"pong")
    watched = oid_of(0)
    r.expect_ok("watch", r.lanes("watch", [
        (watched, [("watch", 7)], {"client": 2})]))
    out = r.lanes("notify", [(watched, [("notify", b"ping", 30.0)], {})])
    assert out[0] == (0, {"replies": {7: b"pong"}, "timed_out": []}), out
    r.expect_ok("unwatch", r.lanes("unwatch", [
        (watched, [("unwatch", 7)], {"client": 2})]))
    out = r.lanes("call", [
        (oid_of(0), [("call", "hello", "record_hello", b"pg")], {}),
        (oid_of(0), [("call", "hello", "say_hello", b"pg")], {})])
    if cfg.profile is None:
        r.expect_ok("call", out)
        assert out[1][1] == b"Hello, pg!", out
    else:
        # classes are refused on erasure pools (EOPNOTSUPP)
        assert [x[0] for x in out] == [-95, -95], out
    r.read_all("read")
    reads = r.lanes("stat", [(o, [("stat",)], {}) for o in r.live()]
                    + [(oid_of(2), [("getxattrs",)], {}),
                       (oid_of(4), [("omap_get",)], {})])
    r.expect_ok("stat", reads)
    assert reads[-1][1] == {"b": b"2"} and \
        reads[-2][1] == {"user.b": b"beta"}, reads[-2:]
    out = r.lanes("absent", [(g, [("read", 0, 0)], {}) for g in gone])
    assert all(x[0] == -2 for x in out), out

    # -- 2. down, degraded writes, up, out ---------------------------
    cluster.mark_down(DOWN)
    cluster.drain()
    r.writes("degraded write", range(cfg.objects, cfg.objects
                                     + DEGRADED_WRITES))
    r.overwrites("degraded overwrite", 2)
    r.read_all("degraded read")
    cluster.mark_up(DOWN)
    cluster.drain()
    r.read_all("recovered read")
    snapshots(r, cfg)
    cluster.mark_out(OUT)
    cluster.drain()
    r.read_all("remapped read")

    # -- 3. bitrot, deep scrub with repair, deep scrub -----------------
    for i, pos in cfg.bitrot:
        oid = r.whole[i]
        pgid = cluster.pgid_of(EC_POOL, oid)
        acting, _ = cluster.acting(pgid)
        shard = pos if cfg.profile is not None else -1
        store = cluster.daemons[acting[pos]].store
        store.faults.mark_bitrot(("pg", str(pgid), shard), oid)
    scrubs["repair"] = cluster.scrub(EC_POOL, deep=True, repair=True)
    scrubs["after"] = cluster.scrub(EC_POOL, deep=True)
    r.read_all("final read")

    # -- 4. what the cluster holds --------------------------------------
    stats, acting = {}, {}
    for pgid in cluster.pgids(EC_POOL):
        acting[str(pgid)] = cluster.acting(pgid)
        stats[str(pgid)] = cluster.primary_pg(pgid).get_stats()
    return {
        "replies": r.replies,
        "model": {o: bytes(d) for o, d in r.model.items() if d is not None},
        "clones": dict(r.clones),
        "mismatches": store_mismatches(cluster, {
            **{o: bytes(d) for o, d in r.model.items() if d is not None},
            **r.clones}, encode),
        "scrubs": {k: {str(p): s for p, s in v.items()}
                   for k, v in scrubs.items()},
        "stats": stats,
        "acting": acting,
        "collections": {osd: cluster.collections(osd)
                        for osd in range(cluster.n)},
        "notifies": len(cluster.notifies),
        "perf": cluster.perf_totals(),
    }
