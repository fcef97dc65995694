"""The reference's PGLog cases over both packages.

``tests/test_pg_log.py``'s authoritative-merge scenarios (PGLog::merge_log)
and helpers, each on the reference's ``ceph_tpu.osd.pg_log`` and on the
port's ``ceph_tpu_torch.osd.pg_log``; then both logs fed one seeded
history and merge, with equal results.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

mod = None


@pytest.fixture(autouse=True, params=["ceph_tpu", "ceph_tpu_torch"])
def _pkg(request):
    global mod
    mod = importlib.import_module(request.param + ".osd.pg_log")
    yield
    mod = None


def E(epoch, version, oid, kind="modify", prior=0):
    return mod.LogEntry(epoch=epoch, version=version, oid=oid, kind=kind,
                    prior_version=prior)


def make_log(*entries):
    log = mod.PGLog()
    for e in entries:
        log.append(e)
    return log


class TestMerge:
    def test_contiguous_extension(self):
        log = make_log(E(1, 1, "a"), E(1, 2, "b"))
        updates, _ = log.merge([E(1, 3, "c"), E(2, 4, "a")], (2, 4))
        assert updates == {"c": 3, "a": 4}
        assert log.head == (2, 4)
        assert [e.ev for e in log.entries] == [(1, 1), (1, 2), (1, 3),
                                               (2, 4)]

    def test_authoritative_delete(self):
        log = make_log(E(1, 1, "a"))
        updates, _ = log.merge([E(2, 2, "a", kind="delete")], (2, 2))
        assert updates == {"a": 0}

    def test_divergent_create_removed(self):
        """A create acked by nobody (dead-interval write) is undone."""
        log = make_log(E(1, 1, "a"), E(1, 2, "b"),
                       E(2, 3, "x", prior=0))
        auth = [E(1, 1, "a"), E(1, 2, "b"), E(3, 3, "y")]
        updates, _ = log.merge(auth, (3, 3))
        assert updates == {"x": 0, "y": 3}
        assert log.head == (3, 3)
        assert all(e.oid != "x" for e in log.entries)

    def test_divergent_modify_reverts_to_auth_version(self):
        log = make_log(E(1, 1, "a"), E(2, 2, "a", prior=1))
        auth = [E(1, 1, "a"), E(3, 2, "b")]
        updates, _ = log.merge(auth, (3, 2))
        assert updates == {"a": 1, "b": 2}

    def test_divergent_delete_resurrects(self):
        """A divergent DELETE (removed in a dead interval) reverts to
        the authoritative object."""
        log = make_log(E(1, 1, "a"),
                       E(2, 2, "a", kind="delete", prior=1))
        auth = [E(1, 1, "a"), E(3, 2, "c")]
        updates, _ = log.merge(auth, (3, 2))
        assert updates == {"a": 1, "c": 2}

    def test_same_version_fork_detected_by_epoch(self):
        """Two primaries minted version 2 in different epochs: the
        losing fork's entry must be rolled back even though the bare
        version numbers collide."""
        log = make_log(E(1, 1, "a"), E(2, 2, "mine", prior=0))
        auth = [E(1, 1, "a"), E(3, 2, "theirs")]
        updates, _ = log.merge(auth, (3, 2))
        assert updates == {"mine": 0, "theirs": 2}

    def test_rewind_empty_segment(self):
        """Authoritative head BEHIND ours with an empty delta: entries
        past auth_head are divergent."""
        log = make_log(E(1, 1, "a"), E(2, 2, "z", prior=0))
        updates, _ = log.merge([], (1, 1))
        assert updates == {"z": 0}
        assert log.head == (1, 1)

    def test_merge_into_empty_log(self):
        log = mod.PGLog()
        updates, _ = log.merge([E(1, 1, "a"), E(1, 2, "b", kind="delete")],
                            (1, 2))
        assert updates == {"a": 1, "b": 0}
        assert log.head == (1, 2)

    def test_noop_merge(self):
        log = make_log(E(1, 1, "a"))
        assert log.merge([], (1, 1)) == ({}, set())
        assert log.head == (1, 1)

    def test_divergent_then_recreate_in_auth(self):
        """Divergent entry for an oid the auth chain later recreates:
        the auth version wins."""
        log = make_log(E(1, 1, "a"), E(2, 2, "a", prior=1))
        auth = [E(1, 1, "a"), E(3, 2, "a", kind="delete"),
                E(3, 3, "a")]
        updates, _ = log.merge(auth, (3, 3))
        assert updates == {"a": 3}


class TestHelpers:
    def test_entries_since_and_overlap(self):
        log = make_log(E(1, 1, "a"), E(1, 2, "b"), E(2, 3, "c"))
        assert [e.oid for e in log.entries_since((1, 1))] == ["b", "c"]
        assert log.overlaps((1, 2))
        assert log.overlaps((0, 0))
        assert not log.overlaps((9, 9)) or log.head == (9, 9)

    def test_dump_load_roundtrip(self):
        log = make_log(E(1, 1, "a"), E(2, 2, "b", kind="delete",
                                       prior=1))
        log2 = mod.PGLog()
        log2.load(log.dump())
        assert log2.dump() == log.dump()
        assert log2.head == log.head

    def test_trim_moves_tail(self):
        log = mod.PGLog()
        log.CAP = 10
        for i in range(1, 25):
            log.append(E(1, i, "o%d" % i))
        assert len(log.entries) == 10
        assert log.tail == (1, 15)
        assert not log.overlaps((1, 3))


class TestChainedDivergence:
    def test_chained_divergent_entries_revert_to_earliest_prior(self):
        """Two divergent writes to one oid: the revert target is the
        EARLIEST divergent entry's prior_version — later priors are
        divergent versions nobody can serve."""
        log = make_log(E(1, 4, "o"), E(2, 5, "o", prior=4),
                       E(2, 6, "o", prior=5))
        auth = [E(1, 4, "o"), E(3, 5, "x")]
        updates, divergent = log.merge(auth, (3, 5))
        assert updates["o"] == 4          # not 5
        assert "o" in divergent
        assert updates["x"] == 5

    def test_trim_reports_dropped_entries(self):
        log = mod.PGLog()
        log.CAP = 3
        dropped = []
        for i in range(1, 6):
            dropped.extend(log.append(E(1, i, "o%d" % i)))
        assert [e.version for e in dropped] == [1, 2]
        assert len(log.entries) == 3


def _history(m, seed):
    """A seeded log of 40 entries over 6 objects, then a merge with an
    authoritative segment that shares its first 25 and forks after."""
    rng = np.random.default_rng(seed)
    log = m.PGLog()
    for v in range(1, 41):
        log.append(m.LogEntry(
            epoch=1 + v // 10, version=v, oid="o%d" % rng.integers(0, 6),
            kind="delete" if rng.random() < 0.2 else "modify",
            prior_version=max(0, v - int(rng.integers(1, 5)))))
    auth = [m.entry_from_tuple(r) for r in log.dump()[:25]]
    for v in range(26, 36):
        auth.append(m.LogEntry(epoch=9, version=v,
                               oid="o%d" % rng.integers(0, 6)))
    updates, divergent = log.merge(auth, (9, 35))
    return updates, sorted(divergent), log.dump(), log.head, log.tail


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_history_equals_the_reference(seed):
    ref = importlib.import_module("ceph_tpu.osd.pg_log")
    assert _history(mod, seed) == _history(ref, seed)
