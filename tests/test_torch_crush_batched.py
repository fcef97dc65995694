"""The port's batched CRUSH mapper against the JAX package's on the
bench's map, on the CPU.

``ceph_tpu_torch.crush.batched.batched_do_rule(device="cpu")`` runs the
plain version of the CUDA kernel (int64 torch); each case holds its
whole output against the JAX package's ``batched_do_rule`` on the same
map, rule, seeds and reweights, rebuilt in each package's own classes.
The map is the bench's (``bench.py:820`` ``_crush_bench_map``: 8 hosts
of 4 OSDs, OSD 3 out) with its indep rule and a firstn one. Cases:
reweights at 0, 0x8000 and a short vector, seeds below 0 and at 2^31
and above, the plain version's chunks, and the scalar fallbacks (a
malformed map, a legacy bucket alg, firstn under exotic tunables), which
:func:`batched.paths` counts, and the extras (``choose_args``,
``device_out``, ``device``, ``xs_sharding``, ``tables_sharding``)
keyword-only; and ``mesh_do_rule`` over flat meshes of ``["cpu"] * n``
and through the rateless queue against the JAX package's over its
virtual devices. The choose_args cases are in
tests/test_torch_crush_weight_sets.py, the 1024-OSD cluster and the rule
shapes in tests/test_torch_crush_rules.py. The reference compiles once per
map, rule and shape (seconds on one core), so each reference output is
computed once per process. Tolerance: none.
"""

import functools

import numpy as np
import pytest
import torch

from ceph_tpu.crush import batched as jbatched
from ceph_tpu.crush import map as jmap
from ceph_tpu_torch.crush import batched, mapper_ref
from ceph_tpu_torch.crush import map as tmap
from ceph_tpu_torch.parallel import mesh as pmesh

from .torch_crush_maps import SEEDS, bench_map, bench_reweight
from .torch_util import one_torch_thread  # noqa: F401

WIDE_SEEDS = np.concatenate([np.arange(-200, 56), 2**31 - 128 + np.arange(256)])


BENCH_CASES = {
    # name: (rule, result_max, reweight, seeds)
    "indep": (0, 5, "plain", SEEDS),
    "indep_half": (0, 5, "half", SEEDS),
    "indep_short": (0, 5, "short", SEEDS),
    "indep_wide_seeds": (0, 5, "half", WIDE_SEEDS),
    "firstn": (1, 3, "half", SEEDS),
    "firstn_short": (1, 3, "short", SEEDS),
    "firstn_wide_seeds": (1, 3, "plain", WIDE_SEEDS),
}


@functools.lru_cache(maxsize=None)
def bench_ref(name):
    rule, rmax, rw, xs = BENCH_CASES[name]
    return jbatched.batched_do_rule(bench_map(jmap), rule, xs, rmax,
                                    bench_reweight(rw))


@pytest.mark.parametrize("name", list(BENCH_CASES))
def test_bench_map(one_torch_thread, name):  # noqa: F811
    rule, rmax, rw, xs = BENCH_CASES[name]
    batched.reset_paths()
    got = batched.batched_do_rule(bench_map(tmap), rule, xs, rmax,
                                  bench_reweight(rw), device="cpu")
    assert batched.paths() == {"kernel": 0, "plain": 1, "scalar": 0}
    np.testing.assert_array_equal(got, bench_ref(name))


def malformed(mod):
    m = mod.CrushMap()
    m.type_names = {"osd": 0, "host": 1, "root": 2}
    m.add_bucket("straw2", 1, [0, 1], [0x10000] * 2, id=-2)
    m.add_bucket("straw2", 2, [-2, -9], [0x20000, 0x20000], id=-1,
                 name="default")
    m.add_rule(mod.Rule(steps=[(mod.RULE_TAKE, -1),
                               (mod.RULE_CHOOSELEAF_INDEP, 2, 1),
                               (mod.RULE_EMIT,)]))
    return m


def legacy_alg(mod):
    m = bench_map(mod)
    b = m.buckets[-2]
    m.buckets[-2] = mod.Bucket(id=-2, alg="uniform", type=1, items=b.items,
                               weights=[0x10000] * b.size)
    return m


def exotic_tunables(mod):
    m = bench_map(mod)
    m.tunables.choose_local_tries = 2
    return m


@pytest.mark.parametrize("make,rule,result_max", [
    (malformed, 0, 2), (legacy_alg, 0, 5), (exotic_tunables, 1, 3)],
    ids=["malformed", "legacy_alg", "firstn_exotic_tunables"])
def test_scalar_fallbacks_are_counted(make, rule, result_max):
    xs = np.arange(-10, 30)
    ref = jbatched.batched_do_rule(make(jmap), rule, xs, result_max)
    batched.reset_paths()
    got = batched.batched_do_rule(make(tmap), rule, xs, result_max,
                                  device="cpu")
    assert batched.paths() == {"kernel": 0, "plain": 0, "scalar": 1}
    np.testing.assert_array_equal(got, ref)


def test_plain_chunks_give_the_same_sweep(one_torch_thread, monkeypatch):  # noqa: F811
    m = bench_map(tmap)
    whole = batched.batched_do_rule(m, 1, SEEDS, 3, bench_reweight("half"),
                                    device="cpu")
    monkeypatch.setattr(batched, "PLAIN_CHUNK_SEEDS", 37)
    cut = batched.batched_do_rule(m, 1, SEEDS, 3, bench_reweight("half"),
                                  device="cpu")
    np.testing.assert_array_equal(cut, whole)
    np.testing.assert_array_equal(whole, bench_ref("firstn"))


def test_extras_are_keyword_only():
    """The reference's sixth parameter is ``xs_sharding`` and its seventh
    ``choose_args`` (``ceph_tpu/crush/batched.py:509-511``); the port's
    extras are keyword-only, so a positional call in the reference's form
    fails loudly instead of mapping with the wrong weight set."""
    m = bench_map(tmap)
    with pytest.raises(TypeError):
        batched.batched_do_rule(m, 0, SEEDS[:8], 5, bench_reweight("plain"),
                                None, None, device="cpu")
    with pytest.raises(TypeError):
        batched.batched_do_rule(m, 0, SEEDS[:8], 5, None, 0)
    out = batched.batched_do_rule(m, 0, SEEDS[:8], 5, None, choose_args=0,
                                  device="cpu")
    assert out.shape == (8, 5)


# -- the mesh-sharded sweep (mesh_do_rule) -------------------------------------

MESH_SEEDS = SEEDS[:250]      # pads at every mesh size below but 1 and 2


@functools.lru_cache(maxsize=None)
def mesh_ref():
    """The JAX package's mesh_do_rule over its 8 virtual devices (its
    sweep at any mesh size and through its queue is this one, which its
    own tests hold against the scalar mapper)."""
    return jbatched.mesh_do_rule(bench_map(jmap), 0, MESH_SEEDS, 5,
                                 bench_reweight("half"),
                                 mesh=jbatched.make_batch_mesh(8))


@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_mesh_do_rule_matches_jax(one_torch_thread, n):  # noqa: F811
    """Seeds padded to the mesh, one sweep a device against its own
    tables, the pad trimmed: the JAX package's sharded sweep and the
    port's single-device one, seed for seed."""
    m = bench_map(tmap)
    batched.reset_paths()
    got = batched.mesh_do_rule(
        m, 0, MESH_SEEDS, 5, bench_reweight("half"),
        mesh=batched.make_batch_mesh(devices=["cpu"] * n))
    assert batched.paths() == {"kernel": 0, "plain": n, "scalar": 0}
    np.testing.assert_array_equal(got, mesh_ref())
    np.testing.assert_array_equal(got, batched.batched_do_rule(
        m, 0, MESH_SEEDS, 5, bench_reweight("half"), device="cpu"))
    for x in MESH_SEEDS[::25]:
        assert list(got[x]) == mapper_ref.crush_do_rule(
            m, 0, int(x), 5, list(bench_reweight("half"))), x


def test_mesh_do_rule_rides_the_rateless_queue(one_torch_thread):  # noqa: F811
    """With no mesh and a dispatcher set, the seeds ride its queue: one
    sweep a micro-batch (a deadline of 10 minutes keeps a loaded host
    from speculating), equal to the JAX package's sweep."""
    from ceph_tpu_torch.parallel import rateless
    rl = rateless.RatelessDispatcher(devices=["cpu"] * 2, factor=2,
                                     timeout_ms=600e3, name="crush-rl")
    rateless.set_dispatcher(rl)
    try:
        batched.reset_paths()
        got = batched.mesh_do_rule(bench_map(tmap), 0, MESH_SEEDS, 5,
                                   bench_reweight("half"))
        assert batched.paths()["plain"] == 4       # factor 2 x 2 workers
        assert sum(d["completed"] for d in rl.device_status()) == 4
    finally:
        rateless.reset_dispatcher()
    np.testing.assert_array_equal(got, mesh_ref())


def test_mesh_extras_are_keyword_only_and_checked(monkeypatch):
    m = bench_map(tmap)
    flat = batched.make_batch_mesh(devices=["cpu"] * 4)
    with pytest.raises(TypeError):
        batched.mesh_do_rule(m, 0, SEEDS[:8], 5, None, flat)
    with pytest.raises(ValueError, match="flat 1-axis"):
        batched.mesh_do_rule(m, 0, SEEDS[:8], 5, mesh=pmesh.make_mesh(
            devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="do not split"):
        batched.batched_do_rule(m, 0, SEEDS[:6], 5, xs_sharding=flat)
    sharded = batched.batched_do_rule(m, 0, SEEDS[:8], 5, xs_sharding=flat,
                                      tables_sharding=flat, device_out=True)
    assert isinstance(sharded, torch.Tensor)
    np.testing.assert_array_equal(sharded.numpy(), batched.batched_do_rule(
        m, 0, SEEDS[:8], 5, device="cpu"))
    monkeypatch.setattr(pmesh, "_local_devices", lambda: [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batched.mesh_do_rule(m, 0, SEEDS[:8], 5)
