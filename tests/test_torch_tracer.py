"""Op tracing of the PyTorch port against the JAX package's.

``ceph_tpu_torch.common.tracer`` mirrors ``tests/test_tracing.py`` on the
reference: the disabled path allocates no span, the config gate and its
hot toggle (through the reference's own Config, which the port reads
duck-typed), 1-in-N sampling, parent / child / continue across
collectors, the back-filled interval, the ring's capacity, the admin
commands, and ``render_tree``'s self-times, whose text must equal the
reference renderer's on the same span dumps. The tail sampler's
verdicts, pending fragments, expiry and overflow are held against the
reference's on the same seeded draws; ``parse_slo_targets`` and the wire
form too. Tolerance: none, beyond the clock readings themselves.
"""

import random
import time

import numpy as np
import torch

from ceph_tpu.common import tracer as ref
from ceph_tpu.common.config import Config
from ceph_tpu_torch.common import tracer as port
from ceph_tpu_torch.common.tracer import (NULL_SPAN, SpanCollector,
                                          TailSampler, device_segments,
                                          render_tree, trace_ctx)


class _Asok:
    """The admin-socket surface register_admin_commands needs."""

    def __init__(self):
        self.cmds = {}

    def register(self, name, fn, desc=""):
        self.cmds[name] = fn

    def execute(self, name, args=None):
        return self.cmds[name](args or {})


def enabled(**kw):
    t = SpanCollector(**kw)
    t.enabled = True
    return t


def test_disabled_allocates_no_spans():
    tracer = SpanCollector(conf=Config({"osd_tracing": False}))
    span = tracer.start_trace("op")
    assert span is NULL_SPAN and not span.valid()
    with span.child("sub") as sub:
        sub.keyval("k", 1)
        sub.event("e")
        assert sub.child_interval("i", 0.0, 1.0) is NULL_SPAN
    assert tracer.continue_trace("x", 123, 45) is NULL_SPAN
    assert tracer.dump() == []
    assert trace_ctx(span) == (0, 0)


def test_config_hot_toggle():
    conf = Config({"osd_tracing": False})
    tracer = SpanCollector(conf=conf)
    assert tracer.start_trace("x") is NULL_SPAN
    conf.set_val("osd_tracing", True)
    conf.apply_changes()
    assert tracer.enabled
    tracer.start_trace("y").finish()
    assert len(tracer.dump()) == 1


def test_sampling_one_in_n_as_the_reference():
    conf = {"osd_tracing": True, "osd_tracing_sample": 4}
    mine = SpanCollector(conf=Config(conf))
    theirs = ref.SpanCollector(conf=Config(conf))
    got = [mine.start_trace("s").valid() for _ in range(16)]
    assert got == [theirs.start_trace("s").valid() for _ in range(16)]
    assert sum(got) == 4
    assert mine.continue_trace("c", 0, 0) is NULL_SPAN


def test_parent_child_and_continue():
    tracer = enabled()
    root = tracer.start_trace("client_op", "client.0")
    child = root.child("messenger")
    remote = enabled(endpoint="osd.1")
    t_id, p_id = trace_ctx(child)
    osd_span = remote.continue_trace("osd_op", t_id, p_id)
    assert osd_span.trace_id == root.trace_id
    assert osd_span.parent_id == child.span_id
    for s in (osd_span, child, root):
        s.finish()
    spans = tracer.dump() + remote.dump()
    by_name = {s["name"]: s for s in spans}
    assert by_name["messenger"]["parent_id"] == root.span_id
    assert by_name["osd_op"]["endpoint"] == "osd.1"
    assert len({s["trace_id"] for s in spans}) == 1
    assert set(by_name["osd_op"]) == set(
        ref.Span(None, "x").dump())       # the reference's dump keys


def test_child_interval_backfill():
    tracer = enabled()
    root = tracer.start_trace("op")
    now = time.monotonic()
    iv = root.child_interval("queued", now - 0.5, now, batch=3)
    assert iv.valid()
    root.finish()
    doc = [s for s in tracer.dump() if s["name"] == "queued"][0]
    assert 0.45 < doc["duration"] < 0.55
    assert doc["keyvals"] == {"batch": 3}
    assert doc["parent_id"] == root.span_id


def test_ring_capacity():
    tracer = enabled(capacity=3)
    for i in range(6):
        tracer.start_trace("s%d" % i).finish()
    assert [s["name"] for s in tracer.dump()] == ["s3", "s4", "s5"]
    tracer.clear()
    assert tracer.dump() == []


def test_admin_commands():
    asok = _Asok()
    tracer = enabled()
    tracer.register_admin_commands(asok)
    span = tracer.start_trace("op")
    span.finish()
    doc = asok.execute("dump_tracing")
    assert doc["num_spans"] == 1 and doc["enabled"] and doc["sample"] == 1
    assert asok.execute("dump_tracing", {"trace_id": str(span.trace_id)}
                        )["num_spans"] == 1
    assert asok.execute("dump_tracing", {"trace_id": span.trace_id + 1}
                        )["num_spans"] == 0
    assert asok.execute("trace reset") == {"reset": True}
    assert asok.execute("dump_tracing")["num_spans"] == 0


def test_render_tree_equals_the_reference():
    tracer = enabled(endpoint="osd.0")
    root = tracer.start_trace("osd_op")
    time.sleep(0.002)
    with root.child("store_commit") as c:
        c.keyval("bytes", 4096)
        time.sleep(0.002)
    now = time.monotonic()
    root.child_interval("gpu_queue", now - 0.001, now)
    root.finish()
    spans = tracer.dump()
    out = render_tree(spans)
    assert out == ref.render_tree(spans)
    assert "osd_op" in out and "store_commit" in out and "self" in out
    assert render_tree(spans, root.trace_id) == out
    orphans = [{"trace_id": 1, "span_id": 2, "parent_id": 99, "name": "x",
                "endpoint": "osd.1", "start": 0.0, "start_wall": 0.0,
                "duration": 0.1, "keyvals": {}, "events": []}]
    assert render_tree(orphans) == ref.render_tree(orphans)
    assert render_tree([]) == "(no spans)"


def test_wire_form_round_trips():
    tracer = enabled()
    span = tracer.start_trace("op")
    span.event("error: eio")
    span.finish()
    rec = span.dump_wire()
    full = span.dump()
    back = port.wire_span(rec, span.trace_id)
    assert {k: back[k] for k in back} == {k: full[k] for k in back}
    assert back == ref.wire_span(rec, span.trace_id)


def test_parse_slo_targets_as_the_reference():
    raw = "rbd:20:0.99, bad, cold:0:0.5,x:1:1.0,hot:2.5:0.999,:3:0.9"
    assert port.parse_slo_targets(raw) == ref.parse_slo_targets(raw)
    assert port.parse_slo_targets(raw) == {"rbd": (0.02, 0.99),
                                           "hot": (0.0025, 0.999)}
    assert port.parse_slo_targets(None) == {}


def test_tail_verdicts_equal_the_reference():
    conf = {"osd_trace_tail_sample_rate": 0.25,
            "mgr_slo_pool_targets": "rbd:10:0.99"}
    mine = TailSampler(conf=Config(conf), rng=random.Random(7))
    theirs = ref.TailSampler(conf=Config(conf), rng=random.Random(7))
    err = [[1, None, "op", "", 0.0, 0.1, {}, [(0.0, "error: eio")]]]
    cases = [("rbd", 0.02, 0, None), ("rbd", 0.001, -5, None),
             ("cold", 0.5, 0, err)] + \
        [("rbd", 0.001, 0, None)] * 40
    for case in cases:
        assert mine.verdict(*case) == theirs.verdict(*case)
    assert mine.stats == theirs.stats
    assert mine.pool_stats == theirs.pool_stats
    assert mine.stats["kept_slo"] == 1 and mine.stats["kept_error"] == 2


def test_tail_pending_fragments_expire_and_overflow():
    sampler = TailSampler(max_pending=2)
    sampler.pending_ttl = 0.5
    tracer = enabled()
    tracer.tail = sampler
    roots = []
    for i in range(3):
        r = tracer.start_trace("op%d" % i)
        r.child("leg").finish()
        r.finish()
        roots.append(r)
    assert sampler.pending_traces() == 2
    assert sampler.stats["pending_overflow"] == 1
    assert sampler.take(roots[0].trace_id) is None   # dropped oldest
    frags = sampler.take(roots[2].trace_id)
    assert [f[2] for f in frags] == ["leg", "op2"]
    assert sampler.sweep(time.monotonic() + 1.0) == 1
    assert sampler.stats["pending_expired"] == 1
    assert sampler.pending_traces() == 0


def test_device_segments_on_the_cpu():
    batch = np.arange(64, dtype=np.uint8).reshape(1, 4, 16)
    t0 = time.perf_counter()
    out, seg = device_segments(lambda x: x ^ 0xFF, batch,
                               torch.device("cpu"))
    wall = time.perf_counter() - t0
    assert np.array_equal(out, batch ^ 0xFF)
    assert set(seg) == {"h2d", "compute", "d2h"}
    assert all(v >= 0 for v in seg.values())
    assert sum(seg.values()) <= wall * 1.05 + 1e-4
