"""The reference's OSD EC path cases over both packages.

``tests/test_osd_ec_path.py``'s cases (stripe math, batched ECUtil encode
and decode, MemStore transactions, WritePlan RMW planning, per-shard
transaction generation, ExtentCache pipelining), each run on the
reference's modules (``ceph_tpu``, its codec the host ``jerasure``) and on
the port's (``ceph_tpu_torch``, ``torch_cuda`` with ``device="cpu"``):
``interval_set``, ``extent_cache``, ``pg_transaction``,
``ec_transaction`` and ``MemStore``. Then one seeded sequence of write
plans through both packages' ``get_write_plan`` and
``generate_transactions``, whose per-shard transactions and written
extents must be equal op for op.
"""

import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

from .torch_util import one_torch_thread  # noqa: F401


def package(name):
    mod = lambda sub: importlib.import_module(name + "." + sub)  # noqa
    registry = mod("registry")
    store = mod("store")

    def make_codec(k=4, m=2):
        profile = {"technique": "reed_sol_van", "k": str(k), "m": str(m)}
        if name == "ceph_tpu":
            return registry.factory("jerasure", profile)
        return registry.factory("torch_cuda", profile, device="cpu")

    return SimpleNamespace(
        IntervalSet=mod("common.interval_set").IntervalSet,
        ExtentMap=mod("common.interval_set").ExtentMap,
        ec_util=mod("osd.ec_util"), ec_transaction=mod("osd.ec_transaction"),
        ExtentCache=mod("osd.extent_cache").ExtentCache,
        PGTransaction=mod("osd.pg_transaction").PGTransaction,
        MemStore=store.MemStore, Transaction=store.Transaction,
        make_codec=make_codec)


@pytest.fixture(scope="module", params=["ceph_tpu", "ceph_tpu_torch"])
def P(request, one_torch_thread):
    return package(request.param)


class _Pkg:
    @pytest.fixture(autouse=True)
    def _pkg(self, P):
        self.P = P


class TestIntervalSet(_Pkg):
    def test_union_coalesce(self):
        s = self.P.IntervalSet()
        s.union_insert(0, 10)
        s.union_insert(20, 10)
        s.union_insert(10, 10)  # bridges
        assert list(s) == [(0, 30)]

    def test_erase_splits(self):
        s = self.P.IntervalSet([(0, 30)])
        s.erase(10, 5)
        assert list(s) == [(0, 10), (15, 15)]

    def test_intersect_contains(self):
        a = self.P.IntervalSet([(0, 10), (20, 10)])
        b = self.P.IntervalSet([(5, 20)])
        assert list(a.intersect(b)) == [(5, 5), (20, 5)]
        assert a.contains(22, 3)
        assert not a.contains(8, 5)
        assert a.intersects(8, 5)
        assert a.size() == 20

    def test_extent_map(self):
        em = self.P.ExtentMap()
        em.insert(0, b"aaaa")
        em.insert(8, b"bbbb")
        assert em.get(0, 4).tobytes() == b"aaaa"
        assert em.get(2, 4) is None  # hole 4..8
        em.insert(4, b"cccc")        # fills the hole, coalesces
        assert em.get(0, 12).tobytes() == b"aaaaccccbbbb"
        em.insert(2, b"XX")          # overwrite
        assert em.get(0, 6).tobytes() == b"aaXXcc"
        em.erase(0, 4)
        assert em.get(0, 4) is None


class TestStripeInfo(_Pkg):
    """stripe_info_t arithmetic (TestECBackend.cc:7 equivalents)."""

    def test_basics(self):
        s = self.P.ec_util.StripeInfo(2, 8192)
        assert s.chunk_size == 4096
        assert s.logical_to_prev_chunk_offset(100) == 0
        assert s.logical_to_prev_chunk_offset(8193) == 4096
        assert s.logical_to_next_chunk_offset(100) == 4096
        assert s.logical_to_prev_stripe_offset(8193) == 8192
        assert s.logical_to_next_stripe_offset(8192) == 8192
        assert s.logical_to_next_stripe_offset(8193) == 16384
        assert s.aligned_logical_offset_to_chunk_offset(16384) == 8192
        assert s.aligned_chunk_offset_to_logical_offset(8192) == 16384
        assert s.offset_len_to_stripe_bounds((8193, 10)) == (8192, 8192)

    def test_invalid_width(self):
        with pytest.raises(ValueError):
            self.P.ec_util.StripeInfo(3, 8192)


class TestECUtilEncodeDecode(_Pkg):
    def test_round_trip_multi_stripe(self):
        codec = self.P.make_codec(4, 2)
        sinfo = self.P.ec_util.StripeInfo(4, 4 * 64)
        rng = np.random.default_rng(1)
        payload = rng.integers(0, 256, size=5 * sinfo.stripe_width,
                               dtype=np.uint8).tobytes()
        shards = self.P.ec_util.encode(sinfo, codec, payload)
        assert set(shards) == set(range(6))
        assert all(len(v) == 5 * sinfo.chunk_size for v in shards.values())

        # lose two shards, reconstruct, reassemble
        survivors = {s: shards[s] for s in (0, 2, 3, 5)}
        out = self.P.ec_util.decode(sinfo, codec, survivors)
        for s in range(6):
            np.testing.assert_array_equal(out[s], shards[s])
        assert self.P.ec_util.decode_concat(sinfo, codec, survivors) == payload

    def test_unaligned_rejected(self):
        codec = self.P.make_codec()
        sinfo = self.P.ec_util.StripeInfo(4, 256)
        with pytest.raises(Exception):
            self.P.ec_util.encode(sinfo, codec, b"x" * 100)

    def test_not_enough_chunks(self):
        codec = self.P.make_codec(4, 2)
        sinfo = self.P.ec_util.StripeInfo(4, 256)
        shards = self.P.ec_util.encode(sinfo, codec, b"y" * 512)
        with pytest.raises(Exception):
            self.P.ec_util.decode(sinfo, codec, {0: shards[0], 1: shards[1],
                                          2: shards[2]})

    def test_hash_info_append_chain(self):
        codec = self.P.make_codec(2, 1)
        sinfo = self.P.ec_util.StripeInfo(2, 128)
        h = self.P.ec_util.HashInfo(3)
        a = self.P.ec_util.encode(sinfo, codec, b"a" * 128)
        b = self.P.ec_util.encode(sinfo, codec, b"b" * 128)
        h.append(0, a)
        h.append(64, b)
        assert h.get_total_chunk_size() == 128
        assert h.get_total_logical_size(sinfo) == 256
        # chained crc differs from single-shot crc of the second append
        h2 = self.P.ec_util.HashInfo(3)
        h2.append(0, b)
        assert h.get_chunk_hash(0) != h2.get_chunk_hash(0)
        # round-trips through the xattr encoding
        h3 = self.P.ec_util.HashInfo.from_dict(
            json.loads(json.dumps(h.to_dict())))
        assert h3.cumulative_shard_hashes == h.cumulative_shard_hashes


class TestMemStore(_Pkg):
    def test_transaction_atomic_ops(self):
        st = self.P.MemStore()
        st.mount()
        t = self.P.Transaction()
        t.create_collection("c")
        t.write("c", "o", 0, b"hello")
        t.setattr("c", "o", "k", b"v")
        t.omap_setkeys("c", "o", {"a": b"1"})
        st.queue_transaction(t)
        assert st.read("c", "o") == b"hello"
        assert st.getattr("c", "o", "k") == b"v"
        assert st.omap_get("c", "o") == {"a": b"1"}

        t2 = self.P.Transaction()
        t2.write("c", "o", 8, b"world")   # hole gets zero-filled
        t2.truncate("c", "o", 10)
        t2.clone("c", "o", "o2")
        st.queue_transaction(t2)
        assert st.read("c", "o") == b"hello\0\0\0wo"
        assert st.read("c", "o2") == st.read("c", "o")

    def test_commit_callbacks(self):
        st = self.P.MemStore()
        t = self.P.Transaction()
        t.create_collection("c")
        hits = []
        t.register_on_applied(lambda: hits.append("applied"))
        t.register_on_commit(lambda: hits.append("commit"))
        st.queue_transaction(t)
        assert hits == ["applied", "commit"]

    def test_eio_injection(self):
        st = self.P.MemStore()
        t = self.P.Transaction()
        t.create_collection("c")
        t.write("c", "o", 0, b"x")
        st.queue_transaction(t)
        st.inject_read_error("c", "o")
        with pytest.raises(OSError):
            st.read("c", "o")
        st.clear_read_error("c", "o")
        assert st.read("c", "o") == b"x"


class TestWritePlan(_Pkg):
    @pytest.fixture(autouse=True)
    def _setup(self, _pkg):
        self.codec = self.P.make_codec(2, 1)
        self.sinfo = self.P.ec_util.StripeInfo(2, 8192)
        self.hinfos = {}

    def get_hinfo(self, oid):
        if oid not in self.hinfos:
            self.hinfos[oid] = self.P.ec_util.HashInfo(3)
        return self.hinfos[oid]

    def plan(self, t):
        return self.P.ec_transaction.get_write_plan(self.sinfo, t,
                                                    self.get_hinfo)

    def test_aligned_append_no_read(self):
        t = self.P.PGTransaction()
        t.create("obj")
        t.write("obj", 0, b"x" * 8192)
        plan = self.plan(t)
        assert "obj" not in plan.to_read
        assert list(plan.will_write["obj"]) == [(0, 8192)]

    def test_partial_overwrite_reads_head_stripe(self):
        # existing 2-stripe object; overwrite a middle sub-range
        self.get_hinfo("obj").set_projected_total_logical_size(
            self.sinfo, 16384)
        t = self.P.PGTransaction()
        t.write("obj", 100, b"y" * 50)
        plan = self.plan(t)
        assert list(plan.to_read["obj"]) == [(0, 8192)]
        assert list(plan.will_write["obj"]) == [(0, 8192)]

    def test_spanning_overwrite_reads_head_and_tail(self):
        self.get_hinfo("obj").set_projected_total_logical_size(
            self.sinfo, 3 * 8192)
        t = self.P.PGTransaction()
        t.write("obj", 100, b"y" * 8192)  # crosses stripes 0 and 1
        plan = self.plan(t)
        # head [0,8192) + tail [8192,16384) coalesce into one extent
        assert list(plan.to_read["obj"]) == [(0, 16384)]
        assert list(plan.will_write["obj"]) == [(0, 16384)]

    def test_append_past_eof_no_read(self):
        self.get_hinfo("obj").set_projected_total_logical_size(
            self.sinfo, 8192)
        t = self.P.PGTransaction()
        t.write("obj", 8192, b"z" * 8192)  # exactly at EOF, aligned
        plan = self.plan(t)
        assert "obj" not in plan.to_read
        assert list(plan.will_write["obj"]) == [(8192, 8192)]

    def test_unaligned_truncate_reads_boundary(self):
        self.get_hinfo("obj").set_projected_total_logical_size(
            self.sinfo, 16384)
        t = self.P.PGTransaction()
        t.truncate("obj", 9000)
        plan = self.plan(t)
        assert list(plan.to_read["obj"]) == [(8192, 8192)]
        assert self.get_hinfo(
            "obj").get_projected_total_logical_size(self.sinfo) == 16384

    def test_truncate_up_extends_with_zeros(self):
        self.get_hinfo("obj").set_projected_total_logical_size(
            self.sinfo, 8192)
        t = self.P.PGTransaction()
        t.truncate("obj", 20000)
        plan = self.plan(t)
        assert list(plan.will_write["obj"]) == [(8192, 24576 - 8192)]

    def test_delete_resets_size(self):
        self.get_hinfo("obj").set_projected_total_logical_size(
            self.sinfo, 16384)
        t = self.P.PGTransaction()
        t.remove("obj")
        t.write("obj", 0, b"w" * 100)
        plan = self.plan(t)
        assert "obj" not in plan.to_read  # fresh object: no RMW read
        assert list(plan.will_write["obj"]) == [(0, 8192)]

    def test_clone_invalidates_cache(self):
        self.get_hinfo("src").set_projected_total_logical_size(
            self.sinfo, 8192)
        t = self.P.PGTransaction()
        t.clone("src", "dst")
        plan = self.plan(t)
        assert plan.invalidates_cache
        assert self.get_hinfo(
            "dst").get_projected_total_logical_size(self.sinfo) == 8192


class TestGenerateTransactions(_Pkg):
    """Full RMW: plan -> readback -> generate -> apply -> verify via
    decode of the stored shards."""

    @pytest.fixture(autouse=True)
    def _setup(self, _pkg):
        self.k, self.m = 2, 1
        self.codec = self.P.make_codec(self.k, self.m)
        self.sinfo = self.P.ec_util.StripeInfo(self.k, 8192)
        self.store = self.P.MemStore()
        self.hinfos = {}
        t = self.P.Transaction()
        for shard in range(3):
            t.create_collection(("pg", shard))
        self.store.queue_transaction(t)

    def get_hinfo(self, oid):
        if oid not in self.hinfos:
            self.hinfos[oid] = self.P.ec_util.HashInfo(self.k + self.m)
        return self.hinfos[oid]

    def cid_of(self, shard):
        return ("pg", shard)

    def apply(self, t, partial_extents=None):
        plan = self.P.ec_transaction.get_write_plan(self.sinfo, t,
                                                    self.get_hinfo)
        txns, written = self.P.ec_transaction.generate_transactions(
            plan, self.codec, self.sinfo, partial_extents or {},
            list(range(self.k + self.m)), self.cid_of)
        for txn in txns.values():
            self.store.queue_transaction(txn)
        return plan, written

    def object_bytes(self, oid, length):
        shards = {s: np.frombuffer(
            self.store.read(self.cid_of(s), oid), dtype=np.uint8)
            for s in range(self.k + self.m)}
        return self.P.ec_util.decode_concat(self.sinfo, self.codec,
                                     shards)[:length]

    def test_create_write_read_back(self):
        payload = bytes(range(256)) * 64  # 16384 = 2 stripes
        t = self.P.PGTransaction()
        t.create("obj")
        t.write("obj", 0, payload)
        _, written = self.apply(t)
        assert self.object_bytes("obj", len(payload)) == payload
        assert written["obj"].get(0, len(payload)).tobytes() == payload
        # hinfo xattr landed on every shard
        for s in range(3):
            raw = self.store.getattr(self.cid_of(s), "obj",
                                     self.P.ec_transaction.HINFO_KEY)
            h = self.P.ec_util.HashInfo.from_dict(json.loads(raw.decode()))
            assert h.get_total_chunk_size() == 8192

    def test_rmw_overwrite_preserves_rest(self):
        payload = b"A" * 16384
        t = self.P.PGTransaction()
        t.create("obj")
        t.write("obj", 0, payload)
        self.apply(t)

        # overwrite 100 bytes inside stripe 0: needs readback of stripe 0
        t2 = self.P.PGTransaction()
        t2.write("obj", 4000, b"B" * 100)
        plan = self.P.ec_transaction.get_write_plan(self.sinfo, t2,
                                                    self.get_hinfo)
        assert list(plan.to_read["obj"]) == [(0, 8192)]
        # simulate the shard readback: decode stripe 0 from the store
        shards = {s: np.frombuffer(
            self.store.read(self.cid_of(s), "obj", 0,
                            self.sinfo.chunk_size), dtype=np.uint8)
            for s in range(3)}
        stripe0 = self.P.ec_util.decode_concat(self.sinfo, self.codec, shards)
        pex = self.P.ExtentMap()
        pex.insert(0, stripe0)
        txns, _ = self.P.ec_transaction.generate_transactions(
            plan, self.codec, self.sinfo, {"obj": pex},
            list(range(3)), self.cid_of)
        for txn in txns.values():
            self.store.queue_transaction(txn)
        expect = b"A" * 4000 + b"B" * 100 + b"A" * (16384 - 4100)
        assert self.object_bytes("obj", 16384) == expect

    def test_truncate_shrinks_shards(self):
        t = self.P.PGTransaction()
        t.create("obj")
        t.write("obj", 0, b"C" * 16384)
        self.apply(t)
        t2 = self.P.PGTransaction()
        t2.truncate("obj", 8192)  # aligned: no RMW
        self.apply(t2)
        for s in range(3):
            assert self.store.stat(
                self.cid_of(s), "obj")["size"] == self.sinfo.chunk_size
        assert self.object_bytes("obj", 8192) == b"C" * 8192

    def test_delete_removes_shards(self):
        t = self.P.PGTransaction()
        t.create("obj")
        t.write("obj", 0, b"D" * 8192)
        self.apply(t)
        t2 = self.P.PGTransaction()
        t2.remove("obj")
        self.apply(t2)
        for s in range(3):
            assert self.store.stat(self.cid_of(s), "obj") is None


class TestExtentCache(_Pkg):
    def test_miss_then_hit_pipelining(self):
        cache = self.P.ExtentCache()
        to_read = self.P.IntervalSet([(0, 8192)])
        will_write = self.P.IntervalSet([(0, 8192)])

        # op A: cold cache -> must read everything
        pin_a = cache.open_write_pin(1)
        must = cache.reserve_extents_for_rmw("o", pin_a, to_read,
                                             will_write)
        assert list(must) == [(0, 8192)]
        cache.present_read("o", 0, b"r" * 8192)
        got = cache.get_remaining_extents_for_rmw("o", to_read)
        assert got.get(0, 8192).tobytes() == b"r" * 8192
        post_a = self.P.ExtentMap()
        post_a.insert(0, b"a" * 8192)
        cache.present_rmw_update("o", post_a)

        # op B overlapping, while A still pinned: sees A's post-image,
        # reads nothing remotely
        pin_b = cache.open_write_pin(2)
        must_b = cache.reserve_extents_for_rmw("o", pin_b, to_read,
                                               will_write)
        assert must_b.empty()
        got_b = cache.get_remaining_extents_for_rmw("o", to_read)
        assert got_b.get(0, 8192).tobytes() == b"a" * 8192

        # releases: object drops from cache only when all pins gone
        cache.release_write_pin(pin_a)
        assert cache.contains_object("o")
        cache.release_write_pin(pin_b)
        assert not cache.contains_object("o")

    def test_disjoint_objects_independent(self):
        cache = self.P.ExtentCache()
        pin = cache.open_write_pin(1)
        must = cache.reserve_extents_for_rmw(
            "x", pin, self.P.IntervalSet([(0, 64)]),
            self.P.IntervalSet([(0, 64)]))
        assert not must.empty()
        assert not cache.contains_object("y")
        cache.release_write_pin(pin)


def _write_sequence(P):
    """Nine seeded PGTransactions (creates, overwrites, a zero, attrs and
    omap, truncates down and up, a clone, a removal) through
    get_write_plan, the readback of each plan's to_read extents from the
    shard stores (decoded), and generate_transactions, applied in turn:
    each step's per-shard transaction ops (chunk bytes and hinfo xattrs
    included) and its written extents. No rename: the planner removes a
    renamed source before it moves it, in both packages."""
    k, m = 4, 2
    codec = P.make_codec(k, m)
    sinfo = P.ec_util.StripeInfo(k, k * 256)
    store = P.MemStore()
    t = P.Transaction()
    for shard in range(k + m):
        t.create_collection(("pg", shard))
    store.queue_transaction(t)
    hinfos: dict = {}

    def get_hinfo(oid):
        if oid not in hinfos:
            hinfos[oid] = P.ec_util.HashInfo(k + m)
        return hinfos[oid]

    def cid_of(shard):
        return ("pg", shard)

    rng = np.random.default_rng(18)

    def data(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    steps = [
        lambda t: (t.create("a"), t.write("a", 0, data(3000)),
                   t.create("b"), t.write("b", 0, data(8192))),
        lambda t: t.write("a", 500, data(700)),
        lambda t: (t.zero("b", 100, 200), t.setattr("a", "x", b"1"),
                   t.omap_setkeys("b", {"k": b"v"})),
        lambda t: t.truncate("a", 1500),
        lambda t: t.truncate("b", 12000),
        lambda t: t.clone("a", "c"),
        lambda t: t.write("a", 2048, data(1024)),
        lambda t: t.remove("b"),
        lambda t: (t.rmattr("a", "x"), t.omap_rmkeys_op("c", ["k"]),
                   t.write("c", 0, data(100))),
    ]
    out = []
    for build in steps:
        t = P.PGTransaction()
        build(t)
        plan = P.ec_transaction.get_write_plan(sinfo, t, get_hinfo)
        partial = {}
        for oid, extents in plan.to_read.items():
            em = P.ExtentMap()
            for off, length in extents:
                c_off, c_len = sinfo.aligned_offset_len_to_chunk(
                    (off, length))
                shards = {s: np.frombuffer(store.read(
                    cid_of(s), oid, c_off, c_len), dtype=np.uint8)
                    for s in range(k + m)}
                em.insert(off, np.frombuffer(P.ec_util.decode_concat(
                    sinfo, codec, shards), dtype=np.uint8))
            partial[oid] = em
        txns, written = P.ec_transaction.generate_transactions(
            plan, codec, sinfo, partial, list(range(k + m)), cid_of)
        for txn in txns.values():
            store.queue_transaction(txn)
        out.append(({s: txn.ops for s, txn in txns.items()},
                    {oid: [(off, d.tobytes()) for off, d in em]
                     for oid, em in written.items()}))
    final = {(s, oid): (store.read(cid_of(s), oid),
                        store.getattrs(cid_of(s), oid))
             for s in range(k + m) for oid in store.list_objects(cid_of(s))}
    return out, final


@pytest.fixture(scope="module")
def sequences(one_torch_thread):
    return {name: _write_sequence(package(name))
            for name in ("ceph_tpu", "ceph_tpu_torch")}


@pytest.mark.parametrize("step", range(9))
def test_write_sequence_step_equals_the_reference(sequences, step):
    ref, port = sequences["ceph_tpu"][0], sequences["ceph_tpu_torch"][0]
    assert port[step] == ref[step]


def test_write_sequence_stores_equal_the_reference(sequences):
    ref, port = sequences["ceph_tpu"][1], sequences["ceph_tpu_torch"][1]
    assert sorted(port) == sorted(ref) and port == ref
    assert {oid for _, oid in port} == {"a", "c"}
    hinfo = json.loads(port[(0, "a")][1]["hinfo_key"].decode())
    assert hinfo["total_chunk_size"] == 768
