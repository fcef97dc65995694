"""The port's plugin registry against the JAX package's.

Every plugin name of ``ceph_tpu.registry`` has its counterpart in
``ceph_tpu_torch.registry``: the host plugins (``jerasure``, ``isa``,
``shec``, ``lrc``, ``msr``, ``example``) under their own names, numpy
on the CPU, and the device plugins under ``_cuda`` names (run here with
``device="cpu"``, the kernels' plain versions). Each port codec's encode
and decode are held byte for byte against the reference's host codec of
the same name on inputs made from numpy seeds (tolerance: none).
"""

import errno
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu import registry as jregistry
from ceph_tpu_torch import registry
from ceph_tpu_torch.errors import ErasureCodeError

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the reference's name -> the port's (the device plugins run on CUDA)
PORT_NAME = {"jerasure": "jerasure", "isa": "isa", "jax_tpu": "torch_cuda",
             "shec": "shec", "shec_tpu": "shec_cuda", "msr": "msr",
             "msr_tpu": "msr_cuda", "lrc": "lrc", "lrc_tpu": "lrc_cuda",
             "example": "example"}
# the reference's host plugin computing the same code as a device plugin
HOST_NAME = {"jax_tpu": "jerasure", "shec_tpu": "shec", "msr_tpu": "msr",
             "lrc_tpu": "lrc"}
PROFILES = {
    "jerasure": {"technique": "cauchy_good", "k": "4", "m": "2",
                 "packetsize": "32"},
    "isa": {"technique": "cauchy", "k": "5", "m": "3"},
    "jax_tpu": {"technique": "reed_sol_van", "k": "6", "m": "3"},
    "shec": {"k": "6", "m": "4", "c": "2"},
    "shec_tpu": {"technique": "single", "k": "4", "m": "3", "c": "2"},
    "msr": {"k": "4", "m": "3"},
    "msr_tpu": {"k": "3", "m": "2"},
    "lrc": {"k": "4", "m": "2", "l": "3"},
    "lrc_tpu": {"k": "4", "m": "2", "l": "3"},
    "example": {},
}
HOST_PLUGINS = ("jerasure", "isa", "shec", "lrc", "msr", "example")


def port_factory(name, profile):
    kw = {"device": "cpu"} if name.endswith("_cuda") else {}
    return registry.factory(name, dict(profile), **kw)


def test_every_reference_plugin_has_a_counterpart():
    assert set(PORT_NAME) == set(jregistry._BUILTIN_LOADERS)
    assert set(PORT_NAME.values()) == set(registry._BUILTIN_LOADERS)


@pytest.mark.parametrize("ref_name", sorted(PORT_NAME))
def test_plugin_builds_and_codes_as_the_reference(ref_name):
    """ENOENT for none of them; encode and a decode of the first
    (decodable) erasure pattern equal the reference's host codec."""
    prof = PROFILES[ref_name]
    mine = port_factory(PORT_NAME[ref_name], prof)
    theirs = jregistry.factory(HOST_NAME.get(ref_name, ref_name), dict(prof))
    assert type(mine).__name__ == type(theirs).__name__
    assert mine.get_profile() == theirs.get_profile()
    n, k = mine.get_chunk_count(), mine.get_data_chunk_count()
    assert (n, k) == (theirs.get_chunk_count(),
                      theirs.get_data_chunk_count())
    raw = np.random.default_rng(len(ref_name)).integers(
        0, 256, 3000, dtype=np.uint8).tobytes()
    enc = mine.encode(set(range(n)), raw)
    want = theirs.encode(set(range(n)), raw)
    assert set(enc) == set(want)
    assert all(np.array_equal(enc[i], want[i]) for i in want)
    lost = {mine.chunk_index(0), mine.chunk_index(n - 1)} if n - k >= 2 \
        else {mine.chunk_index(0)}
    have = {i: enc[i] for i in enc if i not in lost}
    dec = mine.decode(lost, have)
    assert all(np.array_equal(dec[i], enc[i]) for i in lost)
    assert mine.decode_concat(have)[:len(raw)] == raw


@pytest.mark.parametrize("name", HOST_PLUGINS)
def test_host_plugins_never_touch_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        codec = registry.factory(name, dict(PROFILES[name]), device=device)
        assert getattr(codec, "device", None) is None
        assert getattr(codec, "backend", "numpy") == "numpy"
        for layer in getattr(codec, "layers", ()):
            assert layer.codec.backend == "numpy" and \
                layer.codec.device is None


def test_lrc_inner_plugin_follows_the_backend():
    host = registry.factory("lrc", dict(PROFILES["lrc"]))
    card = registry.factory("lrc_cuda", dict(PROFILES["lrc"]), device="cpu")
    assert host.default_inner_plugin == "jerasure"
    assert card.default_inner_plugin == "torch_cuda"
    assert all(layer.codec.backend == "numpy" for layer in host.layers)
    assert all(layer.codec.backend == "torch" for layer in card.layers)


def test_lrc_on_jerasure_equals_reference_lrc():
    """Every decodable double erasure of k=4, m=2, l=3."""
    mine = registry.factory("lrc", dict(PROFILES["lrc"]))
    theirs = jregistry.factory("lrc", dict(PROFILES["lrc"]))
    n = mine.get_chunk_count()
    raw = np.random.default_rng(7).integers(0, 256, 4099,
                                            dtype=np.uint8).tobytes()
    enc = mine.encode(set(range(n)), raw)
    want = theirs.encode(set(range(n)), raw)
    assert all(np.array_equal(enc[i], want[i]) for i in range(n))
    recovered = 0
    for gone in itertools.combinations(range(n), 2):
        have = {i: enc[i] for i in range(n) if i not in gone}
        try:
            exp = theirs.decode(set(gone), have)
        except Exception as e:
            with pytest.raises(ErasureCodeError) as mine_e:
                mine.decode(set(gone), have)
            assert mine_e.value.errno == e.errno
            continue
        got = mine.decode(set(gone), have)
        assert all(np.array_equal(got[i], exp[i]) for i in gone), gone
        assert mine.minimum_to_decode(set(gone), set(have)) == \
            theirs.minimum_to_decode(set(gone), set(have))
        recovered += 1
    assert recovered > 0


@pytest.mark.parametrize("want,costs", [
    ({2}, {0: 1, 1: 9, 2: 1}),
    ({0}, {0: 9, 1: 1, 2: 1}),
    ({0}, {0: 1, 1: 1, 2: 1}),
    ({1}, {0: 2, 1: 5, 2: 3}),
    ({0, 1}, {0: 1, 1: 1, 2: 9}),
    ({0}, {1: 3, 2: 4}),
], ids=["cheap", "expensive_want", "tie", "middle", "both", "two_left"])
def test_example_cost_rule_equals_reference(want, costs):
    mine = registry.factory("example", {})
    theirs = jregistry.factory("example", {})
    assert mine.minimum_to_decode_with_cost(set(want), dict(costs)) == \
        theirs.minimum_to_decode_with_cost(set(want), dict(costs))


def test_cost_rule_of_a_matrix_codec_ignores_costs():
    mine = registry.factory("jerasure", {"k": "4", "m": "2",
                                         "technique": "reed_sol_van"})
    theirs = jregistry.factory("jerasure", {"k": "4", "m": "2",
                                            "technique": "reed_sol_van"})
    costs = {i: 10 - i for i in range(1, 6)}
    assert mine.minimum_to_decode_with_cost({0}, costs) == \
        theirs.minimum_to_decode_with_cost({0}, costs)


@pytest.mark.parametrize("name", ["jerasure", "shec", "lrc", "example"])
def test_repair_surface_defaults(name):
    codec = registry.factory(name, dict(PROFILES[name]))
    assert (codec.supports_repair(), codec.repair_fraction(),
            codec.repair_helper_count()) == (False, 1.0, 0)


@pytest.mark.parametrize("names,loaded", [
    ("jerasure, isa,example", {"jerasure", "isa", "example"}),
    (" msr ,, msr_cuda ", {"msr", "msr_cuda"}),
    (["shec", "lrc"], {"shec", "lrc"}),
    ("", set()),
], ids=["comma_list", "spaces_and_repeats", "iterable", "empty"])
def test_preload(names, loaded):
    reg = registry.ErasureCodePluginRegistry()
    assert reg.disable_dlclose is False
    reg.preload(names)
    assert set(reg.plugins) == loaded


def test_preload_of_an_unknown_plugin_is_enoent():
    reg = registry.ErasureCodePluginRegistry()
    with pytest.raises(ErasureCodeError) as e:
        reg.preload("jerasure,bogus")
    assert e.value.errno == errno.ENOENT
    assert set(reg.plugins) == {"jerasure"}


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
def test_isa_techniques_equal_reference(technique):
    prof = {"technique": technique, "k": "6", "m": "2"}
    mine = registry.factory("isa", dict(prof))
    theirs = jregistry.factory("isa", dict(prof))
    data = np.random.default_rng(6).integers(
        0, 256, (2, 6, mine.get_chunk_size(6 * 4096)), dtype=np.uint8)
    assert np.array_equal(mine.encode_batch(data), theirs.encode_batch(data))
    with pytest.raises(ErasureCodeError) as e:
        registry.factory("isa", {"technique": "liberation", "k": "6",
                                 "m": "2"})
    assert e.value.errno == errno.ENOENT
