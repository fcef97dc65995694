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
``device_out``, ``device``) keyword-only. The choose_args cases are in
tests/test_torch_crush_weight_sets.py, the 1024-OSD cluster and the rule
shapes in tests/test_torch_crush_rules.py. The reference compiles once per
map, rule and shape (seconds on one core), so each reference output is
computed once per process. Tolerance: none.
"""

import functools

import numpy as np
import pytest

from ceph_tpu.crush import batched as jbatched
from ceph_tpu.crush import map as jmap
from ceph_tpu_torch.crush import batched
from ceph_tpu_torch.crush import map as tmap

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
