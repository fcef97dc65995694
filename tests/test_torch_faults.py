"""The store's fault injection and MemStore over both packages.

``FaultSet`` (``store/faults.py``): the seeded 1-in-N selection and the
deterministic bitrot of ``tests/test_self_heal.py::TestFaultSetDeterminism``,
the trip points, and the two packages' victims and flipped bytes equal;
``MemStore`` (``store/mem_store.py``): EIO and bitrot marks on reads,
cleared by a rewrite, kept by a read, and the store's ops applied alike
in both packages (the shard stores of the ECBackend comparison).
"""

import importlib

import pytest

PKGS = ["ceph_tpu", "ceph_tpu_torch"]


def faults_of(name):
    return importlib.import_module(name + ".store.faults")


def store_of(name):
    return importlib.import_module(name + ".store")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def victims(f, n=64):
    out = set()
    for i in range(n):
        try:
            f.check_eio("c", "obj-%d" % i)
        except OSError:
            out.add(i)
    return out


def test_conf_selection_is_seed_stable(pkg):
    FaultSet = faults_of(pkg).FaultSet
    v1 = victims(FaultSet(seed=3, eio_one_in=4))
    v2 = victims(FaultSet(seed=3, eio_one_in=4))
    v3 = victims(FaultSet(seed=4, eio_one_in=4))
    assert v1 == v2 and v1 and v1 != v3
    f = FaultSet()
    f.mark_bitrot("c", "o")
    a = f.corrupt("c", "o", 0, b"x" * 100)
    assert a == f.corrupt("c", "o", 0, b"x" * 100) != b"x" * 100


def test_victims_and_bitrot_equal_the_reference():
    ref, port = faults_of("ceph_tpu"), faults_of("ceph_tpu_torch")
    for seed in range(4):
        assert victims(port.FaultSet(seed=seed, eio_one_in=5)) == \
            victims(ref.FaultSet(seed=seed, eio_one_in=5))
        fr = ref.FaultSet(seed=seed, bitrot_one_in=3)
        fp = port.FaultSet(seed=seed, bitrot_one_in=3)
        for i in range(32):
            data = bytes(range(200))
            assert fp.corrupt("c", "o%d" % i, 0, data) == \
                fr.corrupt("c", "o%d" % i, 0, data)


def test_trip_points(pkg):
    f = faults_of(pkg).FaultSet()
    f.arm_trip("bluefs.compact", 2)
    for _ in range(2):
        with pytest.raises(OSError):
            f.check_trip("bluefs.compact")
    f.check_trip("bluefs.compact")
    assert f.empty()


def test_memstore_marks_cleared_by_a_rewrite(pkg):
    st = store_of(pkg).MemStore()
    Transaction = store_of(pkg).Transaction
    t = Transaction()
    t.create_collection("c")
    t.write("c", "o", 0, b"abcdef")
    st.queue_transaction(t)
    st.faults.mark_bitrot("c", "o")
    rotten = st.read("c", "o")
    assert rotten != b"abcdef" and st.read("c", "o") == rotten
    st.faults.mark_eio("c", "o")
    with pytest.raises(OSError):
        st.read("c", "o")
    t = Transaction()
    t.write("c", "o", 0, b"ABCDEF")
    st.queue_transaction(t)
    assert st.read("c", "o") == b"ABCDEF"


def _store_ops(name):
    S = store_of(name)
    st = S.MemStore()
    t = S.Transaction()
    t.create_collection("c")
    t.write("c", "a", 3, b"hello")
    t.zero("c", "a", 0, 2)
    t.setattr("c", "a", "k", b"v")
    t.omap_setkeys("c", "a", {"x": b"1", "y": b"2"})
    t.clone("c", "a", "b")
    t.truncate("c", "b", 4)
    t.omap_rmkeys("c", "b", ["x"])
    t.rmattr("c", "a", "k")
    t.touch("c", "e")
    t.collection_move_rename("c", "e", "c", "f")
    st.queue_transaction(t)
    return {oid: (st.read("c", oid), st.getattrs("c", oid),
                  st.omap_get("c", oid), st.stat("c", oid))
            for oid in st.list_objects("c")}


def test_memstore_ops_equal_the_reference():
    assert _store_ops("ceph_tpu_torch") == _store_ops("ceph_tpu")
