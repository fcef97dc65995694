"""Lock-order cycle detection.

Port of ``ceph_tpu/common/lockdep.py``, host code the port keeps its own
copy of.

Role of the reference's lockdep (src/common/lockdep.cc, enabled via
the lockdep config option and wired through common/Mutex): every
instrumented lock records, at acquire time, an order edge from each
lock already held by the thread; an edge that closes a cycle in the
global order graph is a potential deadlock and is reported with both
acquisition sites.

Names are per-INSTANCE (e.g. "pg:1.3", "osd:2"), so inversions
between two locks of the same class — the classic PG-A/PG-B deadlock —
are visible, and a pgA->osd, osd->pgB chain is not falsely aliased
into a pg<->osd cycle. (The reference registers by name string too;
instance-unique names are what make that sound.)

Usage: the daemon code creates its locks through make_rlock(name).
With lockdep disabled (the default) that returns a plain
threading.RLock — zero overhead. Enabled (enable(), or the
CEPH_TPU_LOCKDEP env var at process start), it returns a DebugRLock
that feeds the order graph; violations are collected in `violations`
(and raised immediately in strict mode, like the reference's
lockdep_force_backtrace + assert).
"""

from __future__ import annotations

import os
import threading
import traceback

__all__ = ["enable", "disable", "enabled", "make_rlock", "DebugRLock",
           "LockOrderError", "violations", "reset"]


class LockOrderError(RuntimeError):
    pass


_graph_lock = threading.Lock()
_edges: dict[str, set[str]] = {}     # held -> then-acquired
_edge_sites: dict[tuple, str] = {}   # (held, acquired) -> backtrace
_reported: set[tuple] = set()        # cycles already reported once
violations: list[str] = []
_tls = threading.local()

_state = {"enabled": bool(os.environ.get("CEPH_TPU_LOCKDEP")),
          "strict": False}


def enabled() -> bool:
    return _state["enabled"]


def enable(strict: bool = False) -> None:
    _state["enabled"] = True
    _state["strict"] = strict


def disable() -> None:
    _state["enabled"] = False
    _state["strict"] = False


def reset() -> None:
    with _graph_lock:
        _edges.clear()
        _edge_sites.clear()
        _reported.clear()
        violations.clear()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _reaches(src: str, dst: str) -> bool:
    """Is there a path src ->* dst in the order graph? (called with
    _graph_lock held)"""
    seen = set()
    work = [src]
    while work:
        cur = work.pop()
        if cur == dst:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        work.extend(_edges.get(cur, ()))
    return False


def _note_acquire(name: str) -> None:
    st = _stack()
    held = [h for h in st if h != name]
    if held:
        with _graph_lock:
            for h in held:
                if name in _edges.get(h, ()):
                    continue            # edge already known, no recheck
                if _reaches(name, h):
                    if (h, name) in _reported:
                        continue    # one report per offending pair —
                                    # a hot-path inversion must not
                                    # grow the list per acquire
                    _reported.add((h, name))
                    site = _edge_sites.get((name, h), "<unknown>")
                    msg = ("lock order cycle: acquiring %r while "
                           "holding %r, but %r -> %r was established "
                           "at:\n%s\nnow at:\n%s"
                           % (name, h, name, h, site,
                              "".join(traceback.format_stack(limit=8))))
                    violations.append(msg)
                    if _state["strict"]:
                        raise LockOrderError(msg)
                    continue
                _edges.setdefault(h, set()).add(name)
                _edge_sites[(h, name)] = \
                    "".join(traceback.format_stack(limit=8))
    st.append(name)


def _note_release(name: str) -> None:
    st = _stack()
    for i in range(len(st) - 1, -1, -1):
        if st[i] == name:
            del st[i]
            return


class DebugRLock:
    """Named re-entrant lock feeding the order graph. API-compatible
    with threading.RLock including the private hooks Condition uses."""

    def __init__(self, name: str):
        self.name = name
        self._lk = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lk.acquire(blocking, timeout)
        if got and _state["enabled"]:
            try:
                _note_acquire(self.name)
            except LockOrderError:
                # strict mode: the report must not leave the lock held
                # forever (the with-body never runs, so no release)
                self._lk.release()
                raise
        return got

    def release(self) -> None:
        if _state["enabled"]:
            _note_release(self.name)
        self._lk.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    # threading.Condition compatibility
    def _is_owned(self):
        return self._lk._is_owned()

    def _acquire_restore(self, state):
        self._lk._acquire_restore(state)
        if _state["enabled"]:
            _note_acquire(self.name)

    def _release_save(self):
        if _state["enabled"]:
            _note_release(self.name)
        return self._lk._release_save()

    def __repr__(self):
        return "<DebugRLock %s>" % self.name


def make_rlock(name: str):
    """A named lock: DebugRLock under lockdep, plain RLock otherwise."""
    if _state["enabled"]:
        return DebugRLock(name)
    return threading.RLock()
