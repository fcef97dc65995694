"""The port's batched CRUSH mapper with choose_args against the JAX
package's, on the CPU.

The bench's map (tests/test_torch_crush_batched.py) under weight sets of
1 and 3 positions on every bucket, with and without the root's hash ids
replaced, for its indep and firstn rules: the plain version of
``batched_do_rule(device="cpu")`` equals the JAX package's
``batched_do_rule`` on the same inputs; a choose_args index falls back
to the default set, and ``device_out`` returns the tensor. Each
reference output is computed once per process. Tolerance: none.
"""

import functools

import numpy as np
import pytest
import torch

from ceph_tpu.crush import batched as jbatched
from ceph_tpu.crush import map as jmap
from ceph_tpu_torch.crush import batched
from ceph_tpu_torch.crush import map as tmap

from .torch_crush_maps import SEEDS, bench_map, bench_reweight
from .torch_util import one_torch_thread  # noqa: F401


def weight_sets(m, positions, with_ids, seed):
    """choose_args over every bucket of `m`, weight sets of `positions`
    rows and, with_ids, the root's hash ids replaced."""
    rng = np.random.default_rng(seed)
    root = m.bucket_names["default"]
    cargs = {}
    for bid, b in m.buckets.items():
        ws = rng.integers(0x2000, 4 * 0x10000, size=(positions, b.size))
        cargs[bid] = {"weight_set": ws.tolist(),
                      "ids": [int(i) + 5000 for i in rng.permutation(b.size)]
                      if with_ids and bid == root else None}
    return cargs


CASES = {
    # name: (rule, result_max, positions, root ids replaced)
    "indep_args_1": (0, 5, 1, False),
    "indep_args_3_ids": (0, 5, 3, True),
    "firstn_args_1_ids": (1, 3, 1, True),
    "firstn_args_3": (1, 3, 3, False),
}


@functools.lru_cache(maxsize=None)
def reference(name):
    rule, rmax, positions, ids = CASES[name]
    m = bench_map(jmap)
    return jbatched.batched_do_rule(
        m, rule, SEEDS, rmax, bench_reweight("half"),
        choose_args=weight_sets(m, positions, ids, seed=len(name)))


@pytest.mark.parametrize("name", list(CASES))
def test_weight_sets(one_torch_thread, name):  # noqa: F811
    rule, rmax, positions, ids = CASES[name]
    m = bench_map(tmap)
    got = batched.batched_do_rule(
        m, rule, SEEDS, rmax, bench_reweight("half"),
        choose_args=weight_sets(m, positions, ids, seed=len(name)),
        device="cpu")
    np.testing.assert_array_equal(got, reference(name))


def test_device_out_and_choose_args_index(one_torch_thread):  # noqa: F811
    m = bench_map(tmap)
    m.create_choose_args(tmap.DEFAULT_CHOOSE_ARGS, positions=2)
    m.choose_args_adjust_item_weight(tmap.DEFAULT_CHOOSE_ARGS, -3, 5, 0x1000)
    out = batched.batched_do_rule(m, 0, torch.arange(64), 5, device="cpu",
                                  device_out=True, choose_args=7)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int64
    ref = batched.batched_do_rule(
        m, 0, np.arange(64), 5, device="cpu",
        choose_args=m.choose_args[tmap.DEFAULT_CHOOSE_ARGS])
    np.testing.assert_array_equal(out.numpy(), ref)
