"""The dispatcher's telemetry and stage profiler against the JAX package's.

The port's ``GpuDispatcher(device="cpu", tracer=...)`` and the reference's
``TpuDispatcher(tracer=...)`` take the same op sequence, submitted one op
at a time, at depth 1 and at depth 2: two RS k=8, m=3 encodes (the first
traced), decodes on two erasure signatures (the first traced), one fused
store write and an LRC k=4, m=2, l=3 encode. Held equal:

* the key sets of ``telemetry()``, ``dispatch_status()`` and
  ``dispatch_profile()``, nested dicts included;
* ops, dispatches, coalesced, encoded and decoded bytes, per codec label
  too, and the fused-write ledger;
* ``PROFILER.dump()["kernels"]``: the same kernel names, each with the
  same calls (compiles plus cache hits) and number of signatures;
* the ``perf dump`` names under ``port_name`` (``l_tpu_*`` is
  ``l_gpu_*``; ``l_tpu_donated`` is ``l_gpu_reused``; ``PORT_ONLY`` are
  the port's own);
* the span tree's shape (names and nesting) of the traced encode and
  decode, the reference's ``tpu_`` spans being the port's ``gpu_``.

Deviations, each with its reason (``CHANGES.md`` lists them too):

* the memory ledger's ``staging_ring``: the reference's CPU path stages a
  jax device array at depth 2 and accounts it; the port's CPU legs are
  plain calls that stage nothing on a device, so the port leaves the
  category untouched there (a test below swaps in legs that stage, and
  the category then balances to 0);
* at depth 1 the port always times its legs (``l_gpu_h2d`` / compute /
  d2h count every dispatch: the legs are how a codec is handed a device
  tensor, and timing them costs no synchronise beyond the d2h's), where
  the reference times them only while its tracer is enabled; the stage
  machines are credited only while the tracer is enabled, in both.
Tolerance: none (counts, keys and names; times are only range-checked).
"""

import threading

import numpy as np
import pytest

from ceph_tpu import registry as jregistry
from ceph_tpu.common.profiler import PROFILER as REF_PROFILER
from ceph_tpu.common.tracer import SpanCollector as RefCollector
from ceph_tpu.osd.tpu_dispatch import TpuDispatcher
from ceph_tpu_torch import registry
from ceph_tpu_torch.common.perf_counters import PerfCountersCollection
from ceph_tpu_torch.common.profiler import PROFILER
from ceph_tpu_torch.common.tracer import SpanCollector, render_tree
from ceph_tpu_torch.osd import gpu_dispatch
from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RS = {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "8"}
LRC = {"k": "4", "m": "2", "l": "3"}
SIGS = [(0, 1, 2, 3, 4, 5, 6, 7), (3, 4, 5, 6, 7, 8, 9, 10)]
PORT_ONLY = {"l_gpu_h2d_bytes", "l_gpu_adopted", "l_gpu_adopt_failed"}


def port_name(ref_name: str) -> str:
    if ref_name == "l_tpu_donated":
        return "l_gpu_reused"
    return ref_name.replace("l_tpu_", "l_gpu_", 1)


def make_codecs(side):
    """Fresh codecs, so that each run builds its own decode tables."""
    if side == "ref":
        return (jregistry.factory("jax_tpu", dict(RS)),
                jregistry.factory("lrc_tpu", dict(LRC)))
    return (registry.factory("torch_cuda", dict(RS), device="cpu"),
            registry.factory("lrc_cuda", dict(LRC), device="cpu"))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(13)
    rs, lrc = make_codecs("port")
    data = rng.integers(0, 256, (2, 8, 256), dtype=np.uint8)
    full = np.concatenate([data, rs.encode_batch(data)], axis=1)
    fused = rng.integers(0, 4, (4, 8, 256), dtype=np.uint8)
    ldata = rng.integers(0, 256, (2, 4, lrc.get_chunk_size(4 * 256)),
                         dtype=np.uint8)
    return (rs, lrc), data, full, fused, ldata


def drive(side, depth, inputs):
    """The op sequence through one package's dispatcher; returns what the
    comparisons read, with the dispatcher shut down."""
    _, data, full, fused, ldata = inputs
    rs, lrc = make_codecs(side)
    if side == "ref":
        REF_PROFILER.reset()
        tracer = RefCollector()
        disp = TpuDispatcher(max_delay=0.001, tracer=tracer,
                             pipeline_depth=depth)
    else:
        PROFILER.reset()
        tracer = SpanCollector()
        disp = GpuDispatcher(max_delay=0.001, tracer=tracer,
                             pipeline_depth=depth, device="cpu")
    tracer.enabled = True
    try:
        root = tracer.start_trace("encode")
        parity = disp.encode(rs, data, trace=root)
        root.finish()
        disp.encode(rs, data)
        droot = tracer.start_trace("decode")
        decoded = [disp.decode(rs, SIGS[0], np.ascontiguousarray(
            full[:, list(SIGS[0])]), trace=droot)]
        droot.finish()
        decoded.append(disp.decode(rs, SIGS[1], np.ascontiguousarray(
            full[:, list(SIGS[1])])))
        fw = disp.fused_write(rs, fused)
        lpar = disp.encode(lrc, ldata)
        out = {"parity": np.asarray(parity), "decoded": decoded,
               "shard_crcs": fw.shard_crcs, "lrc": np.asarray(lpar),
               "telemetry": disp.telemetry(),
               "status": disp.dispatch_status(),
               "profile": disp.dispatch_profile(),
               "stats": dict(disp.stats), "fused": dict(disp.fused_stats),
               "perf": disp.perf.dump(),
               "spans": tracer.dump(),
               "roots": (root.trace_id, droot.trace_id)}
    finally:
        disp.shutdown()
    prof = (REF_PROFILER if side == "ref" else PROFILER).dump()
    out["kernels"] = {name: (k["compiles"] + k["cache_hits"],
                             k["num_signatures"])
                      for name, k in prof["kernels"].items()}
    out["memory"] = prof["memory"]
    return out


def key_tree(d):
    """The nested key structure of a dict (values dropped)."""
    return {k: key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def shape(spans, trace_id):
    """(name, [children's shapes]) of a trace's root, the reference's
    tpu_ spans renamed to the port's gpu_, siblings in name order."""
    spans = [s for s in spans if s["trace_id"] == trace_id]
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent_id"], []).append(s)

    def walk(s):
        return (s["name"].replace("tpu_", "gpu_"),
                sorted(walk(k) for k in kids.get(s["span_id"], [])))
    roots = [s for s in spans if s["parent_id"] is None]
    assert len(roots) == 1
    return walk(roots[0])


@pytest.fixture(scope="module", params=[1, 2], ids=["depth1", "depth2"])
def runs(request, inputs):
    return (drive("ref", request.param, inputs),
            drive("port", request.param, inputs), request.param)


def test_outputs_equal_the_reference(runs):
    ref, port, _ = runs
    assert np.array_equal(port["parity"], ref["parity"])
    for a, b in zip(port["decoded"], ref["decoded"]):
        assert np.array_equal(a, b)
    assert port["shard_crcs"] == ref["shard_crcs"]
    assert np.array_equal(port["lrc"], ref["lrc"])


def test_report_keys_equal_the_reference(runs):
    ref, port, _ = runs
    for part in ("telemetry", "status", "profile"):
        assert key_tree(port[part]) == key_tree(ref[part]), part


def test_counts_equal_the_reference(runs):
    ref, port, depth = runs
    assert port["stats"] == ref["stats"] == \
        {"ops": 6, "dispatches": 6, "coalesced": 0}
    assert port["fused"] == ref["fused"]
    assert port["fused"]["dispatches"] == 1
    for key in ("ops", "dispatches", "coalesce_ratio", "fused", "codecs",
                "queue_depth"):
        assert port["telemetry"][key] == ref["telemetry"][key], key
    for name in ("l_tpu_ops", "l_tpu_dispatches", "l_tpu_coalesced",
                 "l_tpu_enc_bytes", "l_tpu_dec_bytes",
                 "l_tpu_fused_dispatches", "l_tpu_fused_bytes_in",
                 "l_tpu_fused_bytes_out", "l_tpu_fused_ratio_milli"):
        assert port["perf"][port_name(name)] == ref["perf"][name], name
    st_p, st_r = port["status"], ref["status"]
    for key in ("pipeline_depth", "overlapped", "ring", "ops",
                "dispatches", "fused", "donated_dispatches"):
        assert st_p[key] == st_r[key], key
    assert st_p["pipeline_depth"] == depth


def test_profiler_kernels_equal_the_reference(runs):
    ref, port, _ = runs
    assert port["kernels"] == ref["kernels"]
    assert port["kernels"]["xor_mm.matrix_encode"] == (5, 3)
    assert port["kernels"]["matrix_base.bank_pick"] == (2, 1)
    assert port["kernels"]["fused_transform.program"] == (1, 1)


def test_perf_names_equal_under_the_map(runs):
    ref, port, _ = runs
    mapped = {port_name(n) for n in ref["perf"]}
    assert set(port["perf"]) - mapped == PORT_ONLY
    assert mapped <= set(port["perf"])
    assert {n for n in port["perf"] if n.startswith("l_gpu_stage_")} == {
        "l_gpu_stage_%s_%s" % (stage, state)
        for stage in gpu_dispatch._STAGES for state in gpu_dispatch._STATES}


def test_span_trees_equal_the_reference(runs):
    ref, port, _ = runs
    legs = ("gpu_device", [("compute", []), ("d2h", []), ("h2d", [])])
    for i, name in enumerate(("encode", "decode")):
        mine = shape(port["spans"], port["roots"][i])
        assert mine == shape(ref["spans"], ref["roots"][i])
        assert mine == (name, sorted([("gpu_queue", []), legs]))
    tree = render_tree(port["spans"], port["roots"][0])
    assert "gpu_device" in tree and "self" in tree


def test_profile_fractions_and_verdict(runs):
    _, port, depth = runs
    prof = port["profile"]
    for stage, row in prof["stages"].items():
        for state in gpu_dispatch._STATES:
            assert 0.0 <= row[state + "_frac"] <= 1.0
            assert row[state + "_s"] >= 0.0
    assert 0.0 <= prof["attribution"] <= 1.0
    assert prof["verdict"].startswith(prof["bound"])
    assert prof["verdict"].endswith("%")
    busy = sum(prof["stages"][s]["busy_s"] for s in ("h2d", "compute", "d2h"))
    assert busy > 0.0                 # the legs were attributed, at any depth
    for name, occ in prof["queue_occupancy_avg"].items():
        assert 0.0 <= occ <= float(depth), name


def test_memory_ledger_deviation(runs):
    ref, port, depth = runs
    assert port["memory"]["decode_tables"]["bytes"] == \
        ref["memory"]["decode_tables"]["bytes"] == 2 * 88 * 64
    # the listed deviation: the reference's CPU path stages device arrays
    # when pipelined; the port's CPU legs stage nothing
    assert ("staging_ring" in ref["memory"]) == (depth > 1)
    none = {"bytes": 0, "high_watermark": 0}
    assert port["memory"].get("staging_ring", none) == none


def test_depth1_credits_the_stages_only_when_instrumenting(inputs):
    codecs, data = inputs[0], inputs[1]
    for enabled in (False, True):
        tracer = SpanCollector()
        tracer.enabled = enabled
        disp = GpuDispatcher(device="cpu", pipeline_depth=1, tracer=tracer)
        try:
            disp.encode(codecs[0], data)
            prof = disp.dispatch_profile()
        finally:
            disp.shutdown()
        busy = prof["stages"]["compute"]["busy_s"]
        assert (busy > 0) == enabled
        assert disp.perf.dump()["l_gpu_compute"]["avgcount"] == 1
        assert disp.perf.get("l_gpu_stage_compute_busy") == \
            pytest.approx(busy, abs=1e-6)


class _StagingLegs(gpu_dispatch._HostDevOps):
    """The CPU legs, declared to stage on a device: the ledger's path."""

    stages = True


class _Boom:
    _bitmat = np.ones((8, 16), dtype=np.uint8)
    w = 8

    def encode_batch(self, data):
        raise RuntimeError("boom")


def test_staging_ring_balances_through_the_pipeline(inputs):
    codecs, data = inputs[0], inputs[1]
    PROFILER.mem_set("staging_ring", 0)
    PROFILER.reset()
    disp = GpuDispatcher(device="cpu", max_delay=0.001)
    disp._devops = _StagingLegs()
    try:
        futs = [disp.encode_async(codecs[0], data) for _ in range(4)]
        futs.append(disp.encode_async(_Boom(), data))
        for f in futs[:4]:
            f.result()
        with pytest.raises(RuntimeError, match="boom"):
            futs[4].result()
        coll = PerfCountersCollection()
        coll.add(disp.perf)
        dump = coll.perf_dump()["osd_gpu"]
    finally:
        disp.shutdown()
    row = PROFILER.mem_dump()["staging_ring"]
    assert row["bytes"] == 0
    assert data.nbytes <= row["high_watermark"] <= 5 * 2 * data.nbytes
    assert dump["l_gpu_h2d_bytes"] >= 5 * data.nbytes


def test_reuse_pool_is_the_donated_buffers_category():
    """The staging buffers kept for reuse are on the ledger under the
    reference's donated_buffers (the CUDA legs' pool, driven with CPU
    buffers: the pool itself touches no stream)."""
    import torch
    legs = object.__new__(gpu_dispatch._CudaDevOps)
    legs.device = torch.device("cpu")
    legs._lock = threading.Lock()
    legs._free = {}
    PROFILER.mem_set("donated_buffers", 0)
    bufs = [torch.empty(1000, dtype=torch.uint8) for _ in range(6)]
    for b in bufs:
        legs.release(b)                  # the pool keeps POOL_DEPTH of them
    assert PROFILER.mem_dump()["donated_buffers"]["bytes"] == \
        1000 * gpu_dispatch._CudaDevOps.POOL_DEPTH
    buf, reused = legs._take((1000,), torch.uint8)
    assert reused and buf is bufs[3]
    assert PROFILER.mem_dump()["donated_buffers"]["bytes"] == \
        1000 * (gpu_dispatch._CudaDevOps.POOL_DEPTH - 1)
    legs.close()                         # the dispatcher's shutdown
    assert PROFILER.mem_dump()["donated_buffers"]["bytes"] == 0
    assert legs._take((1000,), torch.uint8)[1] is False


def test_codec_label_and_window():
    disp = GpuDispatcher(device="cpu")
    try:
        codec = registry.factory("torch_cuda", dict(RS), device="cpu")
        assert disp._codec_label(codec) == "ReedSolomonVandermonde_k8m3"
        disp._account_codec(codec, "enc", 10_000_000)
        disp._account_codec(codec, "dec", 5_000_000)
        row = disp.telemetry()["codecs"]["ReedSolomonVandermonde_k8m3"]
        assert row == {"enc_bytes": 10_000_000, "dec_bytes": 5_000_000,
                       "enc_MBps": 1.0, "dec_MBps": 0.5}
        disp.profile_reset()
        prof = disp.dispatch_profile()
        assert prof["window_s"] < 1.0
    finally:
        disp.shutdown()
