"""The port's batched CRUSH mapper against the JAX package's on the
1024-OSD cluster and on the rule shapes, on the CPU.

The cluster is the map of ``crushtool --build --num-osds 1024 host
straw2 16 rack straw2 8 root straw2 0`` (64 hosts of 16 OSDs, 8 racks
of 8 hosts, one root), built by each package's own crushtool, with its
EC rule (chooseleaf indep over hosts, 12 slots: SHEC k=8 m=4) and its
replicated one (chooseleaf firstn over hosts, 3), under a rebalance's
reweights (every 97th OSD out, every 89th from OSD 5 at 0x8000). The
rule shapes: numrep above result_max and numrep <= 0 in indep and
firstn, and a device beside the hosts under the root (a permanent
hole). ``batched_do_rule(device="cpu")`` runs the plain version of the
CUDA kernel; every output equals the JAX package's ``batched_do_rule``
on the same inputs. Tolerance: none.
"""

import functools

import numpy as np
import pytest
import torch

from ceph_tpu.crush import batched as jbatched
from ceph_tpu.crush import map as jmap
from ceph_tpu.tools import crushtool as jcrushtool
from ceph_tpu_torch.crush import batched
from ceph_tpu_torch.crush import map as tmap
from ceph_tpu_torch.tools import crushtool

from .torch_crush_maps import SEEDS, cluster_map, cluster_reweight
from .torch_util import one_torch_thread  # noqa: F401


CLUSTER_CASES = {
    "ec_12": (0, 12, SEEDS),
    "rep_3": (1, 3, SEEDS),
}


@functools.lru_cache(maxsize=None)
def cluster_ref(name):
    rule, rmax, xs = CLUSTER_CASES[name]
    return jbatched.batched_do_rule(cluster_map(jcrushtool), rule, xs, rmax,
                                    cluster_reweight())


@pytest.mark.parametrize("name", list(CLUSTER_CASES))
def test_cluster_map(one_torch_thread, name):  # noqa: F811
    rule, rmax, xs = CLUSTER_CASES[name]
    got = batched.batched_do_rule(cluster_map(crushtool), rule,
                                  torch.from_numpy(xs), rmax,
                                  cluster_reweight(), device="cpu")
    np.testing.assert_array_equal(got, cluster_ref(name))


def flat_rule_map(mod, numrep, op):
    m = mod.CrushMap()
    m.type_names = {"osd": 0, "host": 1}
    m.add_bucket("straw2", 1, list(range(10)),
                 [0x10000 + 0x1000 * i for i in range(10)], id=-1,
                 name="default")
    m.add_rule(mod.Rule(steps=[(mod.RULE_TAKE, -1), (op, numrep, 0),
                               (mod.RULE_EMIT,)]))
    return m


@pytest.mark.parametrize("numrep,result_max", [(6, 4), (0, 4), (-1, 5)])
@pytest.mark.parametrize("op", ["choose_indep", "choose_firstn"])
def test_numrep_against_result_max(one_torch_thread, op, numrep,  # noqa: F811
                                   result_max):
    xs = np.arange(96)
    rw = np.full(10, 0x10000, dtype=np.int64)
    rw[2] = 0
    rw[6] = 0x8000
    ref = jbatched.batched_do_rule(flat_rule_map(jmap, numrep, op), 0, xs,
                                   result_max, rw)
    got = batched.batched_do_rule(flat_rule_map(tmap, numrep, op), 0, xs,
                                  result_max, rw, device="cpu")
    np.testing.assert_array_equal(got, ref)


def device_at_root(mod):
    m = mod.CrushMap()
    m.type_names = {"osd": 0, "host": 1, "root": 2}
    m.add_bucket("straw2", 1, [0, 1], [0x10000, 0x10000], id=-2)
    m.add_bucket("straw2", 1, [2, 3], [0x10000, 0x10000], id=-3)
    m.add_bucket("straw2", 2, [-2, -3, 4], [0x20000, 0x20000, 0x10000],
                 id=-1, name="default")
    m.add_rule(mod.Rule(steps=[(mod.RULE_TAKE, -1),
                               (mod.RULE_CHOOSELEAF_INDEP, 3, 1),
                               (mod.RULE_EMIT,)]))
    return m


def test_device_beside_the_hosts_is_a_permanent_hole(one_torch_thread):  # noqa: F811
    xs = np.arange(200)
    ref = jbatched.batched_do_rule(device_at_root(jmap), 0, xs, 3)
    got = batched.batched_do_rule(device_at_root(tmap), 0, xs, 3,
                                  device="cpu")
    np.testing.assert_array_equal(got, ref)
    assert (got == tmap.CRUSH_ITEM_NONE).any()
