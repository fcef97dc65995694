"""The port's ``AsyncReserver`` against the reference's.

One seeded sequence of requests at mixed priorities, cancels of held and
queued items, slot-count changes and duplicate requests runs through
both packages' reservers; the grants and preemptions each fires, in
order, and the dumps after every step are the same.
"""

import numpy as np
import pytest

from ceph_tpu.common.reserver import AsyncReserver as Ref
from ceph_tpu_torch.common.reserver import AsyncReserver as Port


def sequence(seed: int, steps: int = 300) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        roll = rng.random()
        item = "pg1.%x" % int(rng.integers(0, 24))
        if roll < 0.6:
            out.append(("request", item, int(rng.choice([0, 90, 180,
                                                         250]))))
        elif roll < 0.9:
            out.append(("cancel", item))
        else:
            out.append(("set_max", int(rng.integers(0, 4))))
    return out


def run(cls, seq) -> list:
    r = cls("lane", 2)
    events = []
    for step in seq:
        if step[0] == "request":
            _, item, prio = step
            r.request_reservation(
                item, lambda i=item: events.append(("grant", i)), prio,
                on_preempt=lambda i=item: events.append(("preempt", i)))
        elif step[0] == "cancel":
            events.append(("cancel", step[1],
                           r.cancel_reservation(step[1])))
        else:
            r.set_max(step[1])
        events.append(("dump", r.dump(), r.num_granted(),
                       r.num_waiting()))
    return events


@pytest.mark.parametrize("seed", range(4))
def test_grant_order_equals_the_reference(seed):
    seq = sequence(seed)
    assert run(Port, seq) == run(Ref, seq)


def test_grant_callbacks_run_outside_the_lock():
    """A grant handler may request again (the PG's reservation round)."""
    r = Port("lane", 1)
    got = []
    r.request_reservation(
        "a", lambda: r.request_reservation("b", lambda: got.append("b")))
    assert r.has_reservation("a") and r.num_waiting() == 1
    r.cancel_reservation("a")
    assert got == ["b"]
